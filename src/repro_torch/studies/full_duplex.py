"""Paper Fig. 16/17: full-duplex PCIe transmission vs read:write mix, on the
port.

The counterpart of ``benchmarks/bench_full_duplex.py``, row for row.  System
per §V-D: one requester, one bus, four memory endpoints.  Sweeps the
read:write ratio and the header overhead (normalized to payload length), for
full-duplex and half-duplex bus configurations.  Expected reproduction:

  * full duplex, zero header: a 1:1 mix nearly doubles bandwidth vs read-only;
  * the improvement decays as header overhead grows and vanishes at h == p;
  * half duplex: bandwidth is flat in the mix ratio;
  * bus utility (busy fraction averaged over directions) of single-type
    traffic rises with header overhead; transmission efficiency falls.
"""

from __future__ import annotations

from ..core import topology as T
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import channel_stats, request_stats, to_host
from ..core.verify import verify_built
from .common import Row, StudyLog, Timer, simulate_exact

BW = 64_000
RATIOS = ((1, 0), (3, 1), (2, 1), (1, 1))
HEADERS = (0, 16, 32, 64)


def run_one(read_ratio: float, header: int, duplex: str, n: int = 4000,
            turnaround_ps: int = 2_000, device="cuda", log=None):
    """(bandwidth MB/s, bus utility, transmission efficiency)."""
    log = log or StudyLog()
    with log.phase("lower"):
        topo = T.single_bus(n_mems=4, bw_MBps=BW, duplex=duplex,
                            turnaround_ps=(turnaround_ps if duplex == "half"
                                           else 0))
        graph = topo.build()
        spec = RequesterSpec(node=0, n_requests=n, targets=[2, 3, 4, 5],
                             pattern="uniform", read_ratio=read_ratio,
                             issue_interval_ps=200, seed=11)
        wl = build_workload(graph, [spec], header_bytes=header,
                            warmup_frac=0.0, device=device)
    with log.phase("verify"):
        verify_built(wl, graph).raise_if_failed()
    sched, _ = log.simulate(f"{duplex}/h{header}/rr{read_ratio:g}",
                            simulate_exact, wl.hops, wl.channels,
                            wl.issue_ps)
    rstats = request_stats(wl.hops, sched, wl.issue_ps, wl.payload_bytes,
                           wl.measured)
    cstats = channel_stats(wl.hops, sched, wl.channels)
    # the requester<->switch bus: channels 0 (and 1 when full duplex)
    n_dirs = 2 if duplex == "full" else 1
    util = float(to_host(cstats["utility"])[:n_dirs].mean())
    eff = float(to_host(cstats["efficiency"])[:n_dirs].mean())
    # span-based (conservation-exact) bandwidth: an overloaded open-loop
    # run has no steady completion window, so total payload / makespan is
    # the right estimator here (drain-phase completion bunching otherwise
    # inflates percentile-window estimates)
    return float(rstats["bandwidth_MBps"]), util, eff


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    log = log or StudyLog()
    rows: list[Row] = []
    n = 1200 if quick else 4000
    headers = (0, 32, 64) if quick else HEADERS
    for duplex in ("full", "half"):
        for h in headers:
            base = None
            for r, w in RATIOS:
                rr = r / (r + w)
                with Timer() as t:
                    bw, util, eff = run_one(rr, h, duplex, n, device=device,
                                            log=log)
                if base is None:
                    base = bw
                rows.append(Row(
                    f"fig16_17/{duplex}/h{h}/rw{r}to{w}", t.us,
                    f"bw_MBps={bw:.0f};vs_read_only={bw / base:.2f};"
                    f"bus_utility={util:.2f};efficiency={eff:.2f}",
                ))
    return rows
