"""HDM coherence modes: host-managed (HDM-H) vs device-managed (HDM-DB), on
the port.

The counterpart of ``benchmarks/bench_coherence_modes.py``, row for row
(the paper's §II-A, §II-C scalability argument).  With device-managed
coherence each device carries its own DCOH and coherence traffic resolves
peer to peer; under HDM-H every coherent miss is mediated by the host's
coherency bridge, which adds a host round trip per miss and concentrates
traffic on the host links.

Setup: N accelerators + 1 host on a spine-leaf fabric, each accelerator
issuing coherent accesses to pooled memory devices:

  * HDM-DB: requests route accelerator -> memory directly;
  * HDM-H : requests route accelerator -> host -> memory, so every access
    crosses the host leaf twice.

Reported: aggregate bandwidth and mean latency against accelerator count.
Every schedule is a plain `simulate` on the device, as in the reference.
"""

from __future__ import annotations

import numpy as np

from ..core import topology as T
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import request_stats, simulate, to_host
from ..core.verify import verify_built
from .common import Row, StudyLog, Timer

PORT = 64_000
FIXED = 26_000


def build_fabric(n_acc: int, n_mem: int = 4):
    kinds, links = [], []

    def add(kind):
        kinds.append(kind)
        return len(kinds) - 1

    spines = [add(T.SWITCH), add(T.SWITCH)]
    host_leaf = add(T.SWITCH)
    acc_leaves = [add(T.SWITCH) for _ in range(max(n_acc // 4, 1))]
    mem_leaves = [add(T.SWITCH) for _ in range(max(n_mem // 2, 1))]
    for lf in [host_leaf] + acc_leaves + mem_leaves:
        for sp in spines:
            links.append(T.LinkSpec(lf, sp, PORT, FIXED))
    host = add(T.REQUESTER)
    links.append(T.LinkSpec(host, host_leaf, PORT, FIXED))
    # the host's coherency bridge: the serviceable endpoint HDM-H requests
    # must visit before memory (CXL.cache mediation)
    host_cb = add(T.MEMORY)
    links.append(T.LinkSpec(host_cb, host_leaf, PORT, FIXED))
    accs = []
    for i in range(n_acc):
        a = add(T.REQUESTER)
        accs.append(a)
        links.append(T.LinkSpec(a, acc_leaves[i % len(acc_leaves)], PORT,
                                FIXED))
    mems = []
    for i in range(n_mem):
        m = add(T.MEMORY)
        mems.append(m)
        links.append(T.LinkSpec(m, mem_leaves[i % len(mem_leaves)], PORT,
                                FIXED))
    topo = T.Topology(np.asarray(kinds, np.int64), links, name="coh")
    return topo, host, host_cb, accs, mems


def run_mode(mode: str, n_acc: int, n_per: int = 300, device="cuda",
             log=None):
    """HDM-DB: direct accesses.  HDM-H: each access first visits the host
    (coherency bridge), as two chained transactions: accelerator -> host
    (header snoop), host -> memory (data)."""
    log = log or StudyLog()
    with log.phase("lower"):
        topo, host, host_cb, accs, mems = build_fabric(n_acc)
        graph = topo.build()
        rng = np.random.default_rng(3)
        if mode == "hdm_db":
            specs = [RequesterSpec(node=a, n_requests=n_per, targets=mems,
                                   issue_interval_ps=1_000, seed=i)
                     for i, a in enumerate(accs)]
            n_tx = n_per * n_acc
        else:
            specs = [RequesterSpec(node=a, n_requests=n_per,
                                   targets=[host_cb],
                                   issue_interval_ps=1_000, seed=i,
                                   payload_bytes=16)
                     for i, a in enumerate(accs)]
            # the host relays all traffic to the memories at matching rate
            specs.append(RequesterSpec(node=host, n_requests=n_per * n_acc,
                                       targets=mems,
                                       issue_interval_ps=max(1_000 // n_acc,
                                                             60),
                                       seed=99))
            n_tx = 2 * n_per * n_acc
        wl = build_workload(graph, specs, header_bytes=16, warmup_frac=0.25,
                            route_choice=rng.integers(0, 1 << 20, n_tx),
                            device=device)
    with log.phase("verify"):
        verify_built(wl, graph).raise_if_failed()
    sched = log.simulate(f"{mode}/acc{n_acc}", simulate, wl.hops,
                         wl.channels, wl.issue_ps)
    r = request_stats(wl.hops, sched, wl.issue_ps, wl.payload_bytes,
                      wl.measured)
    if mode == "hdm_db":
        return (float(r["steady_bandwidth_MBps"]),
                float(r["mean_latency_ps"]) / 1e3)
    # latency of a mediated access = snoop leg + data leg (mean of each)
    lat = to_host(r["latency_ps"])
    meas = to_host(wl.measured)
    own = wl.requester != host
    lat_total = lat[meas & own].mean() + lat[meas & ~own].mean()
    relay = wl.requester == host
    comp = to_host(sched.complete)[relay]
    iss = to_host(wl.issue_ps)[relay]
    bw = (n_per * n_acc) * 64 * 1e12 / (comp.max() - iss.min()) / 1e6
    return float(bw), float(lat_total) / 1e3


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    rows: list[Row] = []
    counts = (2, 4) if quick else (2, 4, 8)
    for n_acc in counts:
        with Timer() as t:
            bw_db, lat_db = run_mode("hdm_db", n_acc, device=device, log=log)
            bw_h, lat_h = run_mode("hdm_h", n_acc, device=device, log=log)
        rows.append(Row(
            f"coherence/scale{n_acc}", t.us,
            f"hdm_db_bw={bw_db:.0f};hdm_h_bw={bw_h:.0f};"
            f"dmc_speedup={bw_db / max(bw_h, 1):.2f};"
            f"hdm_db_lat={lat_db:.0f}ns;hdm_h_lat={lat_h:.0f}ns",
        ))
    return rows
