"""Fabric-coupled device coherence: BISnp traffic meets demand congestion,
on the port.

The counterpart of ``examples/coherence_fabric_demo.py``.  The isolated
snoop-filter model (§V-B) fixes the BISnp round trip and miss path as
constants; `core.coherence_traffic` lowers the same protocol onto the
fabric engine, so every BISnp/BIRsp/writeback is a routed transaction
contending with demand traffic.  This demo ramps background demand load on
the device and prints what the isolated model structurally cannot show —
coherence latency rising with fabric congestion, and the measured BISnp
round trip pulling away from its analytic constant.  The SF scans run
through the `sf_scan` kernel and the fabric passes through the fused serve
round, on the card by default:

    PYTHONPATH=src python -m repro_torch.studies.coherence_fabric_demo [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core import topology as T
from ..core.coherence_traffic import CoherenceFabricSpec, simulate_coupled
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import to_host
from ..core.snoop_filter import (CacheConfig, SFConfig, make_skewed_stream,
                                 simulate_sf)
from ..core.traces import request_stream

FOOTPRINT = 512
N = 600
CAP = FOOTPRINT // 10
PORT, FIXED = 64_000, 26_000
BG_PAYLOAD = 1024


def star_fabric(n_req: int = 2, n_bg: int = 3):
    """Coherent requesters + background requesters + DCOH device, one
    switch (the example's fabric, which mirrors
    ``studies.coherence_fabric.build_coherence_fabric``)."""
    kinds = ([T.SWITCH] + [T.REQUESTER] * n_req + [T.MEMORY]
             + [T.REQUESTER] * n_bg)
    links = [T.LinkSpec(i, 0, PORT, FIXED) for i in range(1, len(kinds))]
    graph = T.Topology(np.asarray(kinds, np.int64), links, name="star").build()
    spec = CoherenceFabricSpec(dev_node=n_req + 1,
                               req_nodes=tuple(range(1, n_req + 1)))
    return graph, spec, list(range(n_req + 2, n_req + 2 + n_bg))


def background(graph, bg_nodes, dev, load: float, span_ps: int,
               device="cuda"):
    """Poisson demand on the device at ``load`` x the device link capacity."""
    if load <= 0:
        return None
    interval = max(int(BG_PAYLOAD * 1_000_000 // PORT * len(bg_nodes) / load), 1)
    n = min(int(span_ps // interval) + 1, 3_000)
    specs = [RequesterSpec(node=b, n_requests=n, targets=[dev],
                           read_ratio=0.5, issue_interval_ps=interval,
                           payload_bytes=BG_PAYLOAD, seed=17 + i,
                           issue_jitter="exp")
             for i, b in enumerate(bg_nodes)]
    return build_workload(graph, specs, header_bytes=16, warmup_frac=0.0,
                          device=device)


def run_point(stream, load: float, policy: str = "fifo", device="cuda"):
    addr, wr, rid = stream
    graph, spec, bg_nodes = star_fabric()
    cfg = SFConfig(capacity=CAP, policy=policy, footprint_lines=FOOTPRINT)
    cache = CacheConfig(capacity=CAP)
    iso = simulate_sf(addr, wr, rid, cfg, cache, n_requesters=2,
                      device=device)
    bg = background(graph, bg_nodes, spec.dev_node, load,
                    int(iso.total_time_ps), device)
    out = simulate_coupled(addr, wr, rid, cfg, cache, graph, spec,
                           n_requesters=2, background=bg, max_iters=10,
                           tol_ps=1_000, device=device)
    miss = to_host(out.lowering.miss)
    bl = to_host(out.bisnp_lat_ps)
    return {
        "iso_ns": float(to_host(iso.latency_ps)[miss].mean()) / 1e3,
        "cpl_ns": float(to_host(out.sf.latency_ps)[miss].mean()) / 1e3,
        "bisnp_ns": float(bl[bl > 0].mean()) / 1e3 if (bl > 0).any() else 0.0,
        "iters": out.iters,
        "converged": out.converged,
    }


def load_ramp(device="cuda") -> None:
    stream = make_skewed_stream(N, FOOTPRINT, write_ratio=0.2,
                                n_requesters=2, seed=7, device=device)
    print("== isolated vs fabric-coupled mean miss latency (fifo DCOH) ==")
    print(f"  {'bg load':>8s} {'isolated':>9s} {'coupled':>9s}"
          f" {'BISnp rtt':>10s} {'fixpoint':>9s}")
    for load in (0.0, 0.3, 0.6, 0.9):
        m = run_point(stream, load, device=device)
        print(f"  {load:8.1f} {m['iso_ns']:8.0f}ns {m['cpl_ns']:8.0f}ns"
              f" {m['bisnp_ns']:9.0f}ns  {m['iters']} iters"
              f"{'' if m['converged'] else ' (cap)'}")
    print("  (the isolated column cannot move: its miss path and BISnp RTT"
          " are\n   constants; the coupled column feels the device link's"
          " queueing)")


def trace_mode(device="cuda") -> None:
    print("\n== trace-driven coherence (§V-E workloads, load 0.6) ==")
    for name in ("xsbench", "redis", "silo"):
        stream = request_stream(name, n=N, footprint_lines=FOOTPRINT,
                                n_requesters=2, seed=3, device=device)
        m = run_point(stream, 0.6, device=device)
        print(f"  {name:10s} isolated {m['iso_ns']:5.0f}ns"
              f"  coupled {m['cpl_ns']:5.0f}ns")


def main(device="cuda") -> None:
    load_ramp(device)
    trace_mode(device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
