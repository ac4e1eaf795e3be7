"""Routing strategies over the PBR fabric (paper §V-A, Fig. 13).

Oblivious routing fixes each packet's path statically from (source,
destination) — the interconnect layer's default shortest path (alternative 0),
or hash-spread over the equal-cost set (ECMP flavour).  Adaptive routing picks
among equal-cost alternatives by congestion.  ESF switches adapt hop-by-hop;
here adaptation is expressed as fixpoint route re-selection: simulate, measure
per-channel busy time, re-route every transaction onto its least-loaded
equal-cost alternative, and repeat until the assignment stabilizes.  This is
the same control loop a PBR switch's adaptive arbiter converges to in steady
state, reformulated to keep the data plane tensorized.

The PyTorch port's copy of ``repro.core.routing``.  The schedules resolve on
the workload's device (the card by default); the route choice stays on the
host in float64 numpy, in the reference's order of operations, with the
reference's draws from one seeded generator, so every choice (ties
included) equals the reference's.
"""

from __future__ import annotations

import numpy as np

from .devices import build_workload
from .engine import channel_stats, simulate, to_host
from .topology import FabricGraph

STRATEGIES = ("oblivious", "ecmp", "adaptive")


def _route_channels(graph: FabricGraph, src: int, dst: int, alt: int) -> list[int]:
    path = graph.route(src, dst, alt=alt)
    chans = []
    for u, v in zip(path[:-1], path[1:]):
        chans.append(graph.edge_channel(u, v)[0])
    for u, v in zip(path[::-1][:-1], path[::-1][1:]):
        chans.append(graph.edge_channel(u, v)[0])
    return chans


def route_and_simulate(graph: FabricGraph, specs, strategy: str = "oblivious",
                       adapt_iters: int = 4, seed: int = 0,
                       simulate_fn=simulate, **build_kw):
    """Build + schedule a workload under the given routing strategy.

    Returns (workload, schedule, per-channel stats dict); the workload's
    tables, the schedule and the stats lie on ``build_kw["device"]`` (the
    card by default, as `build_workload`'s).  Every schedule is resolved by
    ``simulate_fn(hops, channels, issue_ps)`` (`engine.simulate` unless the
    caller passes one that, say, records or times it).
    """
    assert strategy in STRATEGIES
    rng = np.random.default_rng(seed)

    def lower(**kw):
        return build_workload(graph, specs, **kw, **build_kw)

    def schedule(wl):
        sched = simulate_fn(wl.hops, wl.channels, wl.issue_ps)
        return wl, sched, channel_stats(wl.hops, sched, wl.channels)

    wl = lower()
    # real transactions only: pseudo-rows (requester -1, e.g. credit-return
    # DLLPs) ride after the demand rows and their count is route-dependent —
    # route choices index the demand prefix (`Workload.n_demand`)
    n = wl.n_demand

    if strategy == "oblivious":
        return schedule(wl)

    # alternative-route universe per transaction
    n_alts = np.array([
        graph.n_route_alternatives(int(s), int(d))
        for s, d in zip(wl.requester[:n], wl.target[:n])
    ])
    if strategy == "ecmp":
        choice = rng.integers(0, 1 << 30, n) % n_alts
        return schedule(lower(route_choice=choice))

    # adaptive: incremental greedy congestion balancing.  A synchronous
    # everyone-flips update oscillates between spines (herd behaviour), so we
    # re-assign transactions one at a time against a live per-channel load
    # estimate — the steady state a per-packet adaptive arbiter converges to.
    alt_chans = {}
    for s, d in set(zip(wl.requester[:n].tolist(), wl.target[:n].tolist())):
        for a in range(graph.n_route_alternatives(s, d)):
            alt_chans[(s, d, a)] = _route_channels(graph, s, d, a)

    bw = to_host(wl.channels.bw_MBps).astype(np.float64)
    load = np.zeros(graph.n_channels)
    contrib = 64.0 * 1e6 / np.maximum(bw, 1)  # ~per-packet channel time

    choice = np.zeros(n, dtype=np.int64)
    for j in range(n):  # initial: least-loaded insertion
        s, d = int(wl.requester[j]), int(wl.target[j])
        k = graph.n_route_alternatives(s, d)
        if k > 1:
            costs = [(load[alt_chans[(s, d, a)]]
                      * contrib[alt_chans[(s, d, a)]]).sum() for a in range(k)]
            choice[j] = int(np.argmin(costs))
        load[alt_chans[(s, d, int(choice[j]))]] += 1

    sched = stats = None
    for _ in range(adapt_iters):
        wl, sched, stats = schedule(lower(route_choice=choice))
        # the busy table comes to the host before any float64 arithmetic
        busy = to_host(stats["busy_ps"]).astype(np.float64)
        changed = 0
        order = rng.permutation(n)
        for j in order:
            s, d = int(wl.requester[j]), int(wl.target[j])
            k = graph.n_route_alternatives(s, d)
            if k <= 1:
                continue
            cur = int(choice[j])
            busy[alt_chans[(s, d, cur)]] -= contrib[alt_chans[(s, d, cur)]] * 1e6
            costs = [busy[alt_chans[(s, d, a)]].sum() for a in range(k)]
            new = int(np.argmin(costs))
            busy[alt_chans[(s, d, new)]] += contrib[alt_chans[(s, d, new)]] * 1e6
            if new != cur:
                choice[j] = new
                changed += 1
        if changed == 0:
            break
    return wl, sched, stats
