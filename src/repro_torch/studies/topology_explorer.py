"""ESF design-space exploration on the port: sweep fabrics, snoop-filter
victim policies and routing strategies.

The counterpart of ``examples/topology_explorer.py``: the bandwidth sweep
over fabrics, the DCOH victim-policy sweep and the routing demo, the
paper's §V exploration loop.  On the card by default:

    PYTHONPATH=src python -m repro_torch.studies.topology_explorer [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core import RequesterSpec, build_workload, request_stats
from ..core.engine import simulate
from ..core.snoop_filter import (CacheConfig, SFConfig, make_skewed_stream,
                                 simulate_sf)
from ..core.topology import TOPOLOGY_BUILDERS, spine_leaf
from .routing import run_strategy

SCALE = 8  # requester/memory pairs


def bandwidth_sweep(device="cuda"):
    print(f"== aggregated bandwidth, scale {2 * SCALE} (x port bw) ==")
    for kind in TOPOLOGY_BUILDERS:
        topo = (spine_leaf(SCALE, per_leaf=4) if kind == "spine_leaf"
                else TOPOLOGY_BUILDERS[kind](SCALE))
        g = topo.build()
        mems = [int(m) for m in topo.memories()]
        specs = [RequesterSpec(node=int(r), n_requests=80 * len(mems),
                               targets=mems, issue_interval_ps=500, seed=i)
                 for i, r in enumerate(topo.requesters())]
        n_tx = sum(s.n_requests for s in specs)
        rng = np.random.default_rng(7)
        wl = build_workload(g, specs, header_bytes=64,
                            route_choice=rng.integers(0, 1 << 20, n_tx),
                            device=device)
        sched = simulate(wl.hops, wl.channels, wl.issue_ps)
        r = request_stats(wl.hops, sched, wl.issue_ps, wl.payload_bytes,
                          wl.measured)
        print(f"  {kind:16s} {float(r['steady_bandwidth_MBps']) / 64_000:5.2f}x"
              f"   mean latency {float(r['mean_latency_ps']) / 1000:6.0f} ns")


def snoop_filter_sweep(device="cuda"):
    print("\n== DCOH victim policy sweep (skewed 90/10 stream) ==")
    footprint, n = 2048, 8000
    cap = int(0.2 * footprint)
    addr, wr, rid = make_skewed_stream(n, footprint, seed=3, device=device)
    base = None
    for pol in ("fifo", "lru", "lfi", "lifo", "mru"):
        res = simulate_sf(addr, wr, rid,
                          SFConfig(capacity=cap, policy=pol,
                                   footprint_lines=footprint),
                          CacheConfig(capacity=cap))
        bw = float(res.bandwidth_MBps)
        base = base or bw
        print(f"  {pol:5s} bandwidth {bw / base:5.2f}x fifo   "
              f"BISnp {int(res.bisnp_events):6d}")


def adaptive_routing_demo(device="cuda"):
    print("\n== routing strategies under noisy neighbours ==")
    for strat in ("oblivious", "ecmp", "adaptive"):
        bw, lat = run_strategy(strat, 200, 250, device=device)
        print(f"  {strat:10s} observed-host bw {bw:5.3f}x port, "
              f"latency {lat:5.0f} ns")


def main(device="cuda") -> None:
    bandwidth_sweep(device)
    snoop_filter_sweep(device)
    adaptive_routing_demo(device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
