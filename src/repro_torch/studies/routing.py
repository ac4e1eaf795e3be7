"""Paper Fig. 13: oblivious vs adaptive routing under noisy neighbours, on
the port.

The counterpart of ``benchmarks/bench_routing.py``, row for row.  Setup per
§V-A: a spine-leaf system with eight memory endpoints, eight noisy
neighbours intensively accessing the memories, and one observed host
accessing at a fixed rate.  We measure the observed host's achieved
bandwidth, normalized to the maximum port bandwidth.

Strategies: oblivious (deterministic shortest-path — all equal-cost ties
resolve to the same spine, so the noisy uplink crowd the host), ecmp
(hash-spread, an oblivious flavour included for reference), adaptive
(congestion-driven re-selection via `core.routing`).  Expected reproduction:
adaptive >> oblivious for the observed host.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..core import topology as T
from ..core.devices import RequesterSpec
from ..core.engine import request_stats, simulate, to_host
from ..core.routing import STRATEGIES, route_and_simulate
from .common import Row, StudyLog, Timer

PORT = 64_000
FIXED = 26_000


def build_system():
    """2 spines; 3 requester leaves (host + 8 noisy); 4 memory leaves (8 mems).

    The memory side has ample uplink capacity (8 ports for ~3.5 ports of
    demand), so the contended resource is the requester-leaf uplink choice —
    exactly where the routing strategy acts.
    """
    kinds, links = [], []

    def add(kind):
        kinds.append(kind)
        return len(kinds) - 1

    spines = [add(T.SWITCH), add(T.SWITCH)]
    rleaves = [add(T.SWITCH) for _ in range(3)]
    mleaves = [add(T.SWITCH) for _ in range(4)]
    for lf in rleaves + mleaves:
        for sp in spines:
            links.append(T.LinkSpec(lf, sp, PORT, FIXED))
    host = add(T.REQUESTER)
    links.append(T.LinkSpec(host, rleaves[0], PORT, FIXED))
    noisy = []
    for i in range(8):
        r = add(T.REQUESTER)
        noisy.append(r)
        links.append(T.LinkSpec(r, rleaves[i % 3], PORT, FIXED))
    mems = []
    for i in range(8):
        m = add(T.MEMORY)
        mems.append(m)
        links.append(T.LinkSpec(m, mleaves[i % 4], PORT, FIXED))
    return T.Topology(np.asarray(kinds, np.int64), links, name="fig13"), host, noisy, mems


def run_strategy(strategy: str, n_host: int, n_noisy: int, device="cuda",
                 log=None):
    """(observed host's bandwidth over one port, its mean latency ns)."""
    log = log or StudyLog()
    with log.phase("lower"):
        topo, host, noisy, mems = build_system()
        graph = topo.build()
    specs = [RequesterSpec(node=host, n_requests=n_host, targets=mems,
                           pattern="uniform", issue_interval_ps=1_200, seed=1)]
    specs += [RequesterSpec(node=r, n_requests=n_noisy, targets=mems,
                            pattern="uniform", issue_interval_ps=2_400, seed=2 + i)
              for i, r in enumerate(noisy)]
    runs = itertools.count()

    def recorded(hops, channels, issue_ps):
        return log.simulate(f"{strategy}/run{next(runs)}", simulate, hops,
                            channels, issue_ps)

    # the lowerings and the route choice; the schedules time themselves
    with log.phase("route"):
        wl, sched, stats = route_and_simulate(
            graph, specs, strategy=strategy, simulate_fn=recorded,
            header_bytes=64, device=device)
    rst = request_stats(wl.hops, sched, wl.issue_ps, wl.payload_bytes,
                        wl.measured)
    host_mask = (wl.requester == host) & to_host(wl.measured)
    lat = to_host(rst["latency_ps"])[host_mask].mean() / 1000.0
    # completions and issue times on the host as int64 before max and min
    comp = to_host(sched.complete)[wl.requester == host]
    iss = to_host(wl.issue_ps)[wl.requester == host]
    host_bw = n_host * 64 * 1e12 / (comp.max() - iss.min()) / 1e6
    return host_bw / PORT, lat


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    log = log or StudyLog()
    n_host = 200 if quick else 600
    n_noisy = 250 if quick else 800
    rows: list[Row] = []
    base = None
    for strat in STRATEGIES:
        with Timer() as t:
            bw, lat = run_strategy(strat, n_host, n_noisy, device=device,
                                   log=log)
        if base is None:
            base = bw
        rows.append(Row(
            f"fig13/{strat}", t.us,
            f"host_norm_bw={bw:.3f};vs_oblivious={bw / base:.2f};host_lat={lat:.0f}ns",
        ))
    return rows
