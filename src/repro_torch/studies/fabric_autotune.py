"""Fabric-aware sharding autotune + straggler what-if, on the port.

The counterpart of ``examples/fabric_autotune.py``: the paper's loop —
simulate the interconnect, then design the system — turned on a training
fleet, a 16x16 TPU v5e pod simulated by `core.fabric_model`.  Every
collective term is one schedule on the card by default:

    PYTHONPATH=src python -m repro_torch.studies.fabric_autotune [--device cpu]
"""

from __future__ import annotations

import argparse

from ..core.autotune import WorkloadDims, autotune
from ..core.fabric_model import TPUFabric, predict_collective
from ..runtime.straggler import estimate_step_impact, mitigation_decision


def main(device="cuda", simulate_fn=None) -> None:
    """Print the example's three sections; ``simulate_fn`` (as in
    `fabric_model.simulate_transfers`) lets a caller record each schedule."""
    fab = TPUFabric(nx=16, ny=16)
    graph = fab.build()

    print("== layout ranking: grok-1-314b train_4k (ESF-engine collective term) ==")
    dims = WorkloadDims(n_layers=64, d_model=6144, d_ff=32768, n_heads=48,
                        n_kv=8, head_dim=128, vocab=131072, batch=256,
                        seq=4096, n_experts=8, top_k=2)
    for s in autotune(dims, fab, graph=graph, use_engine=True, device=device,
                      simulate_fn=simulate_fn)[:4]:
        print(f"  {s.layout.name:12s} step={s.step_s:7.3f} s bound={s.bound:10s} "
              f"hbm={s.hbm_bytes_per_chip / 2**30:5.2f} GiB  "
              f"coll={s.collective_s * 1e3:7.1f} ms")

    print("\n== MoE all-to-all: contention the alpha-beta model misses ==")
    est = predict_collective(fab, graph, "all_to_all", "y", 128 << 20, device,
                             simulate_fn)
    naive = (128 << 20) / 16 * 15 / (50e9 * 2)
    print(f"  ESF engine {est.seconds * 1e3:.2f} ms vs contention-free "
          f"{naive * 1e3:.2f} ms -> factor {est.seconds / naive:.2f}x")

    print("\n== straggler what-if: one chip's links at 0.25x bandwidth ==")
    # grok-1 bf16 grads / 256 chips ~ 2.4 GB/chip reduce-scattered per step
    impact = estimate_step_impact(fab, graph, grad_bytes_per_chip=2_400 << 20,
                                  slow_factor=4.0, compute_s=0.9,
                                  device=device, simulate_fn=simulate_fn)
    print(f"  healthy step {impact['healthy_step_s']:.3f}s, degraded "
          f"{impact['degraded_step_s']:.3f}s (slowdown {impact['slowdown']:.3f}x)")
    for remaining in (200, 20_000):
        d = mitigation_decision(impact["slowdown"], restart_cost_steps=50,
                                remaining_steps=remaining)
        print(f"  {remaining} steps left -> {d}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
