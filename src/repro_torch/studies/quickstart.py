"""Quickstart: the whole stack in a few lines, on the port.

The counterpart of ``examples/quickstart.py``, with ``--device`` (the card
by default):

1. simulate a CXL fabric question with the ESF core (the paper),
2. train a small LM with the fabric-aware framework,
3. check what the autotuner would do on the production pod.

    PYTHONPATH=src python -m repro_torch.studies.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(device="cuda"):
    """Runs the three steps, printing as the reference's example does;
    returns the trainer of step 2 (its ``metrics_log`` holds the losses)."""
    # ---- 1. the paper: which fabric should my 8+8 CXL system use? -------
    from ..core import (RequesterSpec, build_workload, request_stats,
                        simulate)
    from ..core.topology import TOPOLOGY_BUILDERS, spine_leaf

    print("== ESF: normalized bandwidth by fabric topology (scale 16) ==")
    for kind in ("chain", "ring", "fully_connected"):
        topo = (spine_leaf(8, per_leaf=4) if kind == "spine_leaf"
                else TOPOLOGY_BUILDERS[kind](8))
        g = topo.build()
        mems = [int(m) for m in topo.memories()]
        specs = [RequesterSpec(node=int(r), n_requests=160, targets=mems,
                               issue_interval_ps=500, seed=i)
                 for i, r in enumerate(topo.requesters())]
        rng = np.random.default_rng(0)
        wl = build_workload(g, specs, header_bytes=64,
                            route_choice=rng.integers(0, 1 << 20, 160 * 8),
                            device=device)
        sched = simulate(wl.hops, wl.channels, wl.issue_ps)
        r = request_stats(wl.hops, sched, wl.issue_ps, wl.payload_bytes,
                          wl.measured)
        print(f"  {kind:16s} "
              f"{float(r['steady_bandwidth_MBps']) / 64000:.2f}x port")

    # ---- 2. train a tiny LM on the same framework -------------------------
    from ..configs import get_smoke_config
    from ..data.pipeline import DataConfig, make_source
    from ..runtime.trainer import TrainConfig, Trainer

    print("\n== train a smoke-scale llama on this host ==")
    cfg = get_smoke_config("llama3-8b")
    trainer = Trainer(cfg, TrainConfig(steps=30, peak_lr=1e-2,
                                       warmup_steps=5, log_every=10),
                      device=device)
    src = make_source("synthetic", DataConfig(vocab=cfg.vocab, seq_len=32,
                                              global_batch=8))
    trainer.fit(src)

    # ---- 3. what layout would the fabric-aware autotuner pick at scale? ---
    from ..core.autotune import WorkloadDims, autotune
    from ..core.fabric_model import TPUFabric

    print("\n== autotuner: llama3-8b train_4k on a 16x16 v5e pod ==")
    dims = WorkloadDims(n_layers=32, d_model=4096, d_ff=14336, n_heads=32,
                        n_kv=8, head_dim=128, vocab=128256, batch=256,
                        seq=4096)
    for s in autotune(dims, TPUFabric(16, 16), device=device)[:3]:
        print(f"  {s.layout.name:12s} step={s.step_s * 1e3:7.1f} ms "
              f"bound={s.bound} hbm={s.hbm_bytes_per_chip / 2**30:.2f} GiB")
    return trainer


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
