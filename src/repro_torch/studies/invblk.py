"""Paper Fig. 15: InvBlk command length (claim F5), on the port.

The counterpart of ``benchmarks/bench_invblk.py``, row for row.  Setup per
§V-C: two requesters issue sequential (streaming) requests; cache, SF size
and request counts as in §V-B; the SF uses block-length-prioritized victim
selection and clears up to ``invblk_max`` contiguous lines per BISnp.  The
bus is finite, so flushed lines compete with demand traffic.  Each length
is one `simulate_sf` (one `sf_scan` launch on the card).

Expected reproduction: length 2 amortizes BISnp waiting and improves
bandwidth and latency; lengths 3-4 pay growing cache-access overheads and
bus competition from flush data, so they give no further improvement.
"""

from __future__ import annotations

from ..core.engine import to_host
from ..core.snoop_filter import (CacheConfig, SFConfig,
                                 make_sequential_stream, simulate_sf)
from .common import Row, StudyLog, Timer


def run_len(invblk: int, n: int, footprint: int, device="cuda",
            log=None) -> dict:
    log = log or StudyLog()
    cap = int(0.2 * footprint)
    with log.phase("lower"):
        addr, wr, rid = make_sequential_stream(n, footprint, n_requesters=2,
                                               write_ratio=0.5, seed=5,
                                               device=device)
    cfg = SFConfig(capacity=cap, policy="blp", invblk_max=invblk,
                   footprint_lines=footprint, bus_MBps=12_000,
                   writeback_ps=30_000)
    with log.phase("sf_scan"):
        res = simulate_sf(addr, wr, rid, cfg, CacheConfig(capacity=cap),
                          n_requesters=2)
    log.scans.append((f"fig15/invblk_len{invblk}", res))
    lat = to_host(res.latency_ps)[n // 2:]
    return {
        "bandwidth_MBps": float(res.bandwidth_MBps),
        "mean_latency_ns": float(lat.mean()) / 1000.0,
        "bisnp": int(res.bisnp_events),
        "lines": int(res.invalidated_lines),
    }


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    n = 8_000 if quick else 32_000
    footprint = 2_048 if quick else 4_096
    rows: list[Row] = []
    base = None
    for L in (1, 2, 3, 4):
        with Timer() as t:
            m = run_len(L, n, footprint, device=device, log=log)
        if base is None:
            base = m
        rows.append(Row(
            f"fig15/invblk_len{L}", t.us,
            f"bw_vs_len1={m['bandwidth_MBps'] / base['bandwidth_MBps']:.3f};"
            f"lat_vs_len1={m['mean_latency_ns'] / base['mean_latency_ns']:.3f};"
            f"bisnp_vs_len1={m['bisnp'] / max(base['bisnp'], 1):.3f};"
            f"lines={m['lines']}",
        ))
    return rows
