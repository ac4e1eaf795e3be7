"""Verifier smoke: build + statically verify every lowering path, on the
port.

The counterpart of ``repro.analysis.verify_smoke``.  ``python -m
repro_torch.analysis.verify_smoke [--device cpu]`` constructs one small
instance of each lowering the studies exercise — demand workloads,
stochastic link reliability (sampled replay tables + retrain markers),
coherence traffic under both fan-out models (the snoop-filter scan through
`kernels.sf_scan` on the card), and streaming windows — and runs
`repro_torch.core.verify` over the result.  Any structured finding is a bug
in a lowering (or in the verifier's model of its contract) and fails the
run.  The tables are built on ``device`` (the card by default); the
printout is the reference's, line for line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core import topology as T
from ..core import verify
from ..core.coherence_traffic import (CoherenceFabricSpec,
                                      coherence_issue, lower_coherence)
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import make_channels
from ..core.link_layer import FlitConfig
from ..core.snoop_filter import (CacheConfig, SFConfig,
                                 make_skewed_stream, simulate_sf)
from ..core.streaming import stream_windows


def _report(name: str, rep: verify.VerifyReport) -> bool:
    status = "ok" if rep.ok else "FAIL"
    print(f"  {name:<28s} {status}  "
          f"({rep.n_rows} rows x {rep.n_channels} channels)")
    if not rep.ok:
        print(rep.summary())
    return rep.ok


def smoke_demand(device="cuda") -> bool:
    """Deterministic demand lowering on tree + single-bus topologies."""
    ok = True
    for name, topo in [
        ("demand/tree", T.tree(n_pairs=4, bw_MBps=64_000)),
        ("demand/single_bus", T.single_bus(n_mems=3, bw_MBps=64_000)),
    ]:
        graph = topo.build()
        mems = [int(i) for i in
                np.flatnonzero(graph.topo.kinds == T.MEMORY)]
        spec = RequesterSpec(node=int(np.flatnonzero(
                                 graph.topo.kinds == T.REQUESTER)[0]),
                             n_requests=200, targets=mems,
                             read_ratio=0.5, issue_interval_ps=40_000,
                             payload_bytes=256, seed=3)
        wl = build_workload(graph, [spec], header_bytes=64, warmup_frac=0.0,
                            device=device)
        ok &= _report(name, verify.verify_built(wl, graph))
    return ok


def smoke_reliability(device="cuda") -> bool:
    """Stochastic flit reliability: sampled replay bytes, retrain markers,
    chan_pair mirroring — the invariants `rel.*` / `chan.pair` gate."""
    # ber/threshold chosen so the sampled tables actually contain replay
    # bytes AND retrain markers (~170 at this scale) — a quieter link would
    # leave the rel.marker / chan.pair checks vacuous.
    flit = FlitConfig("flit256", ber=1e-4, reliability="stochastic",
                      rel_seed=7, retrain_threshold=2, retrain_ps=2_000_000)
    topo = T.with_flit(T.single_bus(n_mems=4, bw_MBps=64_000), flit)
    graph = topo.build()
    spec = RequesterSpec(node=0, n_requests=600, targets=[2, 3, 4, 5],
                         pattern="uniform", read_ratio=0.5,
                         issue_interval_ps=100, payload_bytes=944, seed=11)
    wl = build_workload(graph, [spec], header_bytes=64, warmup_frac=0.0,
                        device=device)
    return _report("reliability/stochastic", verify.verify_built(wl, graph))


def _coherence(graph, spec, fanout: str, n_req: int, device):
    addr, wr, rid = make_skewed_stream(300, 256, write_ratio=0.3,
                                       n_requesters=n_req, seed=5,
                                       device=device)
    cfg = SFConfig(capacity=32, policy="fifo", footprint_lines=256)
    _, ev = simulate_sf(addr, wr, rid, cfg, CacheConfig(capacity=32),
                        n_requesters=n_req, return_events=True)
    low = lower_coherence(graph, spec, cfg, addr, wr, rid, ev, fanout=fanout,
                          device=device)
    ch = make_channels(graph, device=device)
    issue = coherence_issue(low, ev.fab_issue_ps)
    return verify.verify_workload(low.hops, ch, issue, sf_events=ev,
                                  chan_pair=graph.chan_pair)


def smoke_coherence(device="cuda") -> bool:
    """Coherence lowering: serialized chain and fork/join concurrent
    fan-out (the `join.*` invariants only exist on the concurrent path)."""
    n_req = 2
    kinds = [T.SWITCH] + [T.REQUESTER] * n_req + [T.MEMORY]
    links = [T.LinkSpec(i, 0, 64_000, 26_000) for i in range(1, len(kinds))]
    graph = T.Topology(np.asarray(kinds, np.int64), links,
                       name="star").build()
    spec = CoherenceFabricSpec(dev_node=n_req + 1,
                               req_nodes=tuple(range(1, n_req + 1)))
    ok = True
    for fanout in ("chain", "concurrent"):
        ok &= _report(f"coherence/{fanout}",
                      _coherence(graph, spec, fanout, n_req, device))
    return ok


def smoke_streaming(device="cuda") -> bool:
    """Every window a trace splitter emits must verify stand-alone (the
    same precondition `streaming.simulate_stream` checks per chunk)."""
    topo = T.single_bus(n_mems=3, bw_MBps=64_000)
    graph = topo.build()
    spec = RequesterSpec(node=0, n_requests=500, targets=[2, 3, 4],
                         read_ratio=0.5, issue_interval_ps=30_000,
                         payload_bytes=128, seed=9)
    wl = build_workload(graph, [spec], header_bytes=64, warmup_frac=0.0,
                        device=device)
    ok, n = True, 0
    for i, (h, issue) in enumerate(
            stream_windows(wl.hops, wl.issue_ps, 128)):
        rep = verify.verify_workload(h, wl.channels, issue)
        n += 1
        if not rep.ok:
            ok = _report(f"streaming/window[{i}]", rep)
    if ok:
        print(f"  {'streaming/windows':<28s} ok  ({n} windows)")
    return ok


def main(device="cuda") -> int:
    print("verify_smoke: static verification of every lowering path")
    ok = True
    ok &= smoke_demand(device)
    ok &= smoke_reliability(device)
    ok &= smoke_coherence(device)
    ok &= smoke_streaming(device)
    print("verify_smoke:", "clean" if ok else "FINDINGS — see above")
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the lowerings are built (default the card)")
    sys.exit(main(ap.parse_args().device))
