"""Stochastic link reliability: replay bursts, tail latency, retraining, on
the port.

The counterpart of ``examples/link_reliability_demo.py``.  The
expected-value CRC-replay model gives every packet the same stretch, so the
deterministic sweeps of `link_explorer` can never show a tail.  This demo
runs the same saturated bus in ``reliability="stochastic"`` mode — seeded
per-flit Go-Back-N replay sampling plus retraining stalls — and prints what
changes.  Every schedule runs through the fused serve round, on the card by
default:

    PYTHONPATH=src python -m repro_torch.studies.link_reliability_demo [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.calibration import PCIE6_X16_RAW_MBPS
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import simulate, to_host
from ..core.link_layer import FlitConfig
from ..core.topology import single_bus, with_flit


def build(flit, n: int = 1200, device="cuda"):
    topo = with_flit(single_bus(n_mems=4, bw_MBps=PCIE6_X16_RAW_MBPS), flit)
    spec = RequesterSpec(node=0, n_requests=n, targets=[2, 3, 4, 5],
                         read_ratio=0.5, issue_interval_ps=100,
                         payload_bytes=944, seed=11)
    return build_workload(topo.build(), [spec], warmup_frac=0.0,
                          device=device)


def latencies_ns(wl) -> np.ndarray:
    sched = simulate(wl.hops, wl.channels, wl.issue_ps)
    assert bool(sched.converged)
    return to_host(sched.complete - wl.issue_ps) / 1000


def tail_sweep(device="cuda") -> None:
    print("== p50 / p99 request latency (ns): expected vs stochastic ==")
    print(f"  {'BER':>8s} {'exp p50':>9s} {'exp p99':>9s}"
          f" {'sto p50':>9s} {'sto p99':>9s} {'sto p99/p50':>12s}")
    for ber in (0.0, 1e-6, 1e-5, 3e-5, 1e-4):
        le = latencies_ns(build(FlitConfig("flit256", ber=ber),
                                device=device))
        ls = latencies_ns(build(FlitConfig(
            "flit256", ber=ber, reliability="stochastic", rel_seed=1),
            device=device))
        print(f"  {ber:8.0e} {np.percentile(le, 50):9.0f}"
              f" {np.percentile(le, 99):9.0f}"
              f" {np.percentile(ls, 50):9.0f} {np.percentile(ls, 99):9.0f}"
              f" {np.percentile(ls, 99) / np.percentile(ls, 50):12.2f}")
    print("  (expected mode scales every packet alike; the stochastic p99"
          " pulls away\n   from its p50 as replay bursts land on unlucky"
          " packets)")


def retraining_demo(device="cuda") -> None:
    print("\n== retraining stalls (BER 1e-4, threshold 2, 1 us per event) ==")
    cfg_off = FlitConfig("flit256", ber=1e-4, reliability="stochastic",
                         rel_seed=1, retrain_threshold=0)
    cfg_on = FlitConfig("flit256", ber=1e-4, reliability="stochastic",
                        rel_seed=1, retrain_threshold=2,
                        retrain_ps=1_000_000)
    wl_off, wl_on = build(cfg_off, device=device), build(cfg_on, device=device)
    events = int((to_host(wl_on.hops.retrain_after_ps) > 0).sum())
    l_off, l_on = latencies_ns(wl_off), latencies_ns(wl_on)
    print(f"  sampled retraining events : {events}")
    print(f"  makespan without retraining: {l_off.max():8.0f} ns")
    print(f"  makespan with retraining   : {l_on.max():8.0f} ns")
    print(f"  p99 without / with         : {np.percentile(l_off, 99):.0f}"
          f" / {np.percentile(l_on, 99):.0f} ns")
    print("  (same seeded fault history; only the link-down intervals"
          " differ)")


def main(device="cuda") -> None:
    tail_sweep(device)
    retraining_demo(device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
