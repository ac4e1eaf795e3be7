"""Paper Fig. 18/19/20: real-world trace replay (claim F7), on the port.

The counterpart of ``benchmarks/bench_traces.py``, row for row.  Replays the
five representative workload traces (synthetic stand-ins with the published
access statistics; `core.traces`) through ESF:

  * Fig. 18/19: throughput and mean latency on the five fabric topologies,
    normalized to chain.  Paper targets: ring 1.72x/0.57x, spine-leaf
    2.27x/0.44x, fully-connected 3.63x/0.28x (throughput/latency vs chain).
  * Fig. 20a: execution speedup of a full-duplex vs half-duplex bus per
    trace, ordered by the trace's R/W mix degree.
  * Fig. 20b: per-1000-access bandwidth vs window mix degree; the paper
    reports ~+9% bandwidth per +0.1 mix degree.
"""

from __future__ import annotations

import numpy as np

from ..core import topology as T
from ..core import traces as TR
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import request_stats, simulate, to_host
from ..core.verify import verify_built
from .common import Row, StudyLog, Timer, simulate_exact
from .topology import FABRICS, PORT_MBPS, build_topo


def replay_topology(kind: str, trace: dict, n_pairs: int = 8,
                    per_req: int = 400, interval_ps: int = 1_000,
                    seed: int = 0, device="cuda", log=None):
    """Shard the trace across the fabric's requesters and replay.  Returns
    (throughput MB/s, mean latency ns)."""
    log = log or StudyLog()
    with log.phase("lower"):
        topo = build_topo(kind, n_pairs)
        graph = topo.build()
        reqs = topo.requesters()
        mems = [int(m) for m in topo.memories()]
        specs = []
        for i, r in enumerate(reqs):
            lo = i * per_req
            specs.append(RequesterSpec(
                node=int(r), n_requests=per_req, targets=mems,
                issue_interval_ps=interval_ps, seed=seed,
                trace_addr=trace["addr"][lo:lo + per_req],
                trace_is_write=trace["is_write"][lo:lo + per_req],
            ))
        rng = np.random.default_rng(seed + 23)
        n_tx = per_req * len(reqs)
        wl = build_workload(graph, specs, header_bytes=64, warmup_frac=0.0,
                            route_choice=rng.integers(0, 1 << 20, n_tx),
                            device=device)
    with log.phase("verify"):
        verify_built(wl, graph).raise_if_failed()
    sched = log.simulate(f"{trace['name']}/{kind}", simulate, wl.hops,
                         wl.channels, wl.issue_ps)
    r = request_stats(wl.hops, sched, wl.issue_ps, wl.payload_bytes,
                      wl.measured)
    thr = float(r["bandwidth_MBps"])
    lat = float(r["mean_latency_ps"]) / 1000.0
    return thr, lat


def replay_bus(trace: dict, duplex: str, n: int = 3000, device="cuda",
               log=None):
    """(bandwidth MB/s, completion times as host int64)."""
    log = log or StudyLog()
    with log.phase("lower"):
        topo = T.single_bus(n_mems=4, bw_MBps=PORT_MBPS, duplex=duplex,
                            turnaround_ps=1_000 if duplex == "half" else 0)
        graph = topo.build()
        spec = RequesterSpec(node=0, n_requests=n, targets=[2, 3, 4, 5],
                             issue_interval_ps=300, seed=3,
                             trace_addr=trace["addr"],
                             trace_is_write=trace["is_write"])
        wl = build_workload(graph, [spec], header_bytes=16, warmup_frac=0.0,
                            device=device)
    with log.phase("verify"):
        verify_built(wl, graph).raise_if_failed()
    sched, _ = log.simulate(f"{trace['name']}/bus_{duplex}/n{n}",
                            simulate_exact, wl.hops, wl.channels,
                            wl.issue_ps)
    comp = to_host(sched.complete)
    makespan = comp.max() - int(to_host(wl.issue_ps).min())
    return n * 64 * 1e12 / makespan / 1e6, comp  # MB/s, completions


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    log = log or StudyLog()
    rows: list[Row] = []
    per_req = 150 if quick else 400
    n_bus = 2_000 if quick else 6_000
    names = list(TR.WORKLOADS)

    # ---- Fig. 18/19: topology impact on real traces ----------------------
    targets_thr = {"ring": 1.72, "spine_leaf": 2.27, "fully_connected": 3.63}
    targets_lat = {"ring": 0.57, "spine_leaf": 0.44, "fully_connected": 0.28}
    for name in (names if not quick else names[:3]):
        tr = TR.generate(name, n=8 * per_req, footprint_lines=1 << 14, seed=1)
        base_thr = base_lat = None
        for kind in FABRICS:
            with Timer() as t:
                thr, lat = replay_topology(kind, tr, per_req=per_req,
                                           device=device, log=log)
            if base_thr is None:
                base_thr, base_lat = thr, lat
            rows.append(Row(
                f"fig18_19/{name}/{kind}", t.us,
                f"thr_vs_chain={thr / base_thr:.2f};lat_vs_chain={lat / base_lat:.2f};"
                f"paper_thr={targets_thr.get(kind, 1.0):.2f};"
                f"paper_lat={targets_lat.get(kind, 1.0):.2f}",
            ))

    # ---- Fig. 20a: full- vs half-duplex speedup by mix degree -------------
    speedups = []
    for name in names:
        tr = TR.generate(name, n=n_bus, footprint_lines=1 << 14, seed=2)
        with Timer() as t:
            bw_f, comp_f = replay_bus(tr, "full", n=n_bus, device=device,
                                      log=log)
            bw_h, _ = replay_bus(tr, "half", n=n_bus, device=device, log=log)
        sp = bw_f / bw_h
        speedups.append((tr["mix_degree"], sp))
        rows.append(Row(
            f"fig20a/{name}", t.us,
            f"mix_degree={tr['mix_degree']:.2f};fullduplex_speedup={sp:.2f}",
        ))
    speedups.sort()
    mono = all(b[1] >= a[1] - 0.05 for a, b in zip(speedups, speedups[1:]))
    rows.append(Row("fig20a/monotone_in_mix", 0.0, f"monotone={mono}"))

    # ---- Fig. 20b: windowed bandwidth vs mix degree (slope per +0.1) ------
    # Issue-ordered windows of consecutive accesses on a *saturated* bus:
    # window bandwidth = window size / time the bus spent completing it.
    # (Completion-ordered windows conflate phases of the queue and can even
    # show negative slopes — issue order is what Fig. 20b plots.)
    tr = TR.generate("silo", n=n_bus, footprint_lines=1 << 14, seed=4)
    _, comp = replay_bus(tr, "full", n=n_bus, device=device, log=log)
    win = 200 if quick else 500
    xs, ys = [], []
    wr = tr["is_write"][:n_bus]
    windows = range(win, n_bus - 2 * win, win)
    for lo in windows:
        w = float(wr[lo:lo + win].mean())
        mix = min(w, 1 - w)
        dur = float(np.max(comp[lo:lo + win]) - np.max(comp[lo - win:lo]))
        if dur > 0:
            xs.append(mix)
            ys.append(win * 64 * 1e12 / dur / 1e6 / PORT_MBPS)
    if len(xs) > 2:
        slope = float(np.polyfit(xs, ys, 1)[0])
        mean_y = float(np.mean(ys))
        slope_rel = slope * 0.1 / mean_y  # fractional bw gain per +0.1 mix
    else:
        slope_rel = float("nan")
    rows.append(Row(
        "fig20b/mix_bandwidth_slope", 0.0,
        f"rel_slope_per_0.1_mix={slope_rel:+.3f};paper=+0.09;n_windows={len(xs)}",
    ))
    return rows
