"""Paper Fig. 10/11/12: system bandwidth & latency across fabric topologies,
on the port.

The counterpart of ``benchmarks/bench_topology.py``, row for row: claim F1
(chain/tree saturate at ~1x port bandwidth; ring ~2x; spine-leaf ~N/2;
fully-connected ~N) and F2 (hop-count latency breakdown; bridge-route
congestion; ISO-bisection comparison).

Experimental setup mirrors §V-A: N requesters + N memories on PBR switches,
uniform random traffic of every requester to every memory, port bandwidth
fixed, bandwidth normalized to one switch port.  Header bytes = payload
(64 B CXL flit realism) so request and response packets both load the fabric.

Every run resolves through plain `simulate` with the default budget, as the
reference's does: a fabric whose fixpoint needs more rounds than
`round_bound` (the ring at scale 16 needs 83 against 71) ends at the bound
and its row says ``converged=False``.
"""

from __future__ import annotations

import numpy as np

from ..core import topology as T
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import channel_stats, request_stats, simulate, to_host
from ..core.verify import verify_built
from .common import Row, StudyLog, Timer

PORT_MBPS = 64_000
FIXED_PS = 26_000  # 25 ns port delay + 1 ns bus
FLOOD_IV_PS = 500
LOAD_IV_PS = 6_000
FABRICS = ("chain", "tree", "ring", "spine_leaf", "fully_connected")


def _specs(topo: T.Topology, n_per_pair: int, interval_ps: int, seed: int = 0):
    reqs = topo.requesters()
    mems = topo.memories()
    return [
        RequesterSpec(node=int(r), n_requests=n_per_pair * len(mems),
                      targets=[int(m) for m in mems], pattern="uniform",
                      read_ratio=1.0, issue_interval_ps=interval_ps,
                      footprint_lines=4096 * len(mems), seed=seed + i)
        for i, r in enumerate(reqs)
    ]


def build_topo(kind: str, n_pairs: int, bw: int = PORT_MBPS) -> T.Topology:
    kw = dict(bw_MBps=bw, fixed_ps=FIXED_PS)
    if kind == "spine_leaf":
        return T.spine_leaf(n_pairs, n_spines=2, per_leaf=min(4, n_pairs), **kw)
    return T.TOPOLOGY_BUILDERS[kind](n_pairs, **kw)


def workload(topo: T.Topology, n_per_pair: int, interval_ps: int,
             seed: int = 0, device="cuda"):
    """The §V-A workload on ``topo``: (fabric graph, lowered workload).

    ECMP tie-breaking spreads equal-cost flows (the PBR default; without
    it, deterministic alternative-0 routing collapses ring/spine-leaf onto a
    single boundary link — visible if ``route_choice`` is omitted)."""
    graph = topo.build()
    specs = _specs(topo, n_per_pair, interval_ps)
    n_tx = sum(sp.n_requests for sp in specs)
    rng = np.random.default_rng(seed + 17)
    return graph, build_workload(graph, specs, header_bytes=64,
                                 route_choice=rng.integers(0, 1 << 20, n_tx),
                                 device=device)


def run_one(kind: str, n_pairs: int, n_per_pair: int, interval_ps: int,
            bw: int = PORT_MBPS, seed: int = 0, device="cuda", log=None):
    log = log or StudyLog()
    with log.phase("lower"):
        graph, wl = workload(build_topo(kind, n_pairs, bw), n_per_pair,
                             interval_ps, seed, device)
    with log.phase("verify"):
        verify_built(wl, graph).raise_if_failed()
    sched = log.simulate(f"{kind}/pairs{n_pairs}/iv{interval_ps}/bw{bw}",
                         simulate, wl.hops, wl.channels, wl.issue_ps)
    rstats = request_stats(wl.hops, sched, wl.issue_ps, wl.payload_bytes,
                           wl.measured)
    cstats = channel_stats(wl.hops, sched, wl.channels)
    return wl, sched, rstats, cstats


# Analytic bisection link counts for the ISO-bisection configuration (Fig. 12)
def bisection_links(kind: str, n_pairs: int) -> int:
    if kind in ("chain", "tree"):
        return 1
    if kind == "ring":
        return 2
    if kind == "spine_leaf":
        return 2 * max(n_pairs // 4, 1)      # spines x requester leaves
    if kind == "fully_connected":
        return n_pairs * n_pairs             # direct req-side/mem-side links
    raise KeyError(kind)


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    log = log or StudyLog()
    rows: list[Row] = []
    scales = (2, 4, 8) if quick else (2, 4, 8, 16)
    n_per_pair = 30 if quick else 120

    # ---- Fig. 10: normalized aggregate bandwidth vs scale ---------------
    for kind in FABRICS:
        for n_pairs in scales:
            with Timer() as t:
                _, sched, rstats, _ = run_one(kind, n_pairs, n_per_pair,
                                              FLOOD_IV_PS, device=device,
                                              log=log)
            norm_bw = float(rstats["steady_bandwidth_MBps"]) / PORT_MBPS
            rows.append(Row(
                f"fig10/{kind}/scale{2 * n_pairs}", t.us,
                f"norm_bw={norm_bw:.2f};target={_fig10_target(kind, n_pairs):.2f};"
                f"converged={bool(sched.converged)}",
            ))

    # ---- Fig. 11: latency grouped by hop count (scale 16) ----------------
    n_pairs = 4 if quick else 8
    for kind in FABRICS:
        with Timer() as t:
            wl, sched, rstats, _ = run_one(kind, n_pairs, n_per_pair,
                                           LOAD_IV_PS, device=device, log=log)
        lat = to_host(rstats["latency_ps"]) / 1000.0
        wait = to_host(rstats["queue_wait_ps"]) / 1000.0
        hops = wl.n_link_hops
        meas = to_host(wl.measured)
        parts = []
        for h in np.unique(hops):
            m = meas & (hops == h)
            if m.sum():
                parts.append(f"h{h}:lat={lat[m].mean():.0f}ns:wait={wait[m].mean():.0f}ns")
        rows.append(Row(f"fig11/{kind}/scale{2 * n_pairs}", t.us, ";".join(parts)))

    # ---- Fig. 12: ISO-bisection-bandwidth latency -----------------------
    base_bisect = bisection_links("fully_connected", n_pairs)
    for kind in FABRICS:
        scale = max(base_bisect // bisection_links(kind, n_pairs), 1)
        with Timer() as t:
            wl, sched, rstats, _ = run_one(kind, n_pairs, n_per_pair,
                                           LOAD_IV_PS, bw=PORT_MBPS * scale,
                                           device=device, log=log)
        lat = to_host(rstats["latency_ps"]) / 1000.0
        hops = wl.n_link_hops
        meas = to_host(wl.measured)
        lo = lat[meas & (hops == hops[meas].min())].mean()
        hi = lat[meas & (hops == hops[meas].max())].mean()
        rows.append(Row(
            f"fig12/{kind}/iso_bisection", t.us,
            f"mean_lat={lat[meas].mean():.0f}ns;minhop={lo:.0f}ns;maxhop={hi:.0f}ns;"
            f"congestion_ratio={hi / max(lo, 1e-9):.2f}",
        ))
    return rows


def _fig10_target(kind: str, n_pairs: int) -> float:
    n = n_pairs
    return {"chain": 1.0, "tree": 1.0, "ring": 2.0,
            "spine_leaf": n / 2, "fully_connected": float(n)}[kind]
