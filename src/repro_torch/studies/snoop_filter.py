"""Paper Fig. 14: snoop-filter victim selection policies (claim F4), on the
port.

The counterpart of ``benchmarks/bench_snoop_filter.py``, row for row.
Setup per §V-B: one requester issues coherent requests in a skewed pattern
(90 % of accesses to the hot 10 % of the footprint); its local cache (20 %
of the footprint) filters hits; the bus is infinite, to isolate the SF;
SF capacity equals the cache.  Policies: FIFO, LRU, LFI, LIFO, MRU.  Each
policy is one `simulate_sf` (one `sf_scan` launch on the card).

Expected reproduction: FIFO/LRU victimize hot entries and behave alike,
LIFO/MRU victimize just-inserted cold entries (higher bandwidth, lower
latency, fewer back-invalidations), LFI lands between the two pairs.
"""

from __future__ import annotations

from ..core.calibration import FIG14_TARGETS
from ..core.engine import to_host
from ..core.snoop_filter import (CacheConfig, SFConfig, make_skewed_stream,
                                 simulate_sf)
from .common import Row, StudyLog, Timer

POLICY_ORDER = ("fifo", "lru", "lfi", "lifo", "mru")


def run_policy(policy: str, n: int, footprint: int, device="cuda",
               log=None) -> dict:
    log = log or StudyLog()
    cap = int(0.2 * footprint)
    with log.phase("lower"):
        addr, wr, rid = make_skewed_stream(n, footprint, hot_frac=0.1,
                                           hot_ratio=0.9, write_ratio=0.1,
                                           seed=3, device=device)
    cfg = SFConfig(capacity=cap, policy=policy, footprint_lines=footprint)
    with log.phase("sf_scan"):
        res, events = simulate_sf(addr, wr, rid, cfg,
                                  CacheConfig(capacity=cap), n_requesters=1,
                                  return_events=True)
    log.scans.append((f"fig14/{policy}", res))
    log.events[f"fig14/{policy}"] = events
    lat = to_host(res.latency_ps)[n // 2:]  # steady-state half
    return {
        "bandwidth_MBps": float(res.bandwidth_MBps),
        "mean_latency_ns": float(lat.mean()) / 1000.0,
        "invalidations": int(res.bisnp_events),
        "hit_rate": float(to_host(res.cache_hit).mean()),
    }


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    n = 8_000 if quick else 32_000
    footprint = 2_048 if quick else 4_096
    rows: list[Row] = []
    base = None
    for pol in POLICY_ORDER:
        with Timer() as t:
            m = run_policy(pol, n, footprint, device=device, log=log)
        if base is None:
            base = m
        rows.append(Row(
            f"fig14/{pol}", t.us,
            f"bw_vs_fifo={m['bandwidth_MBps'] / base['bandwidth_MBps']:.3f};"
            f"lat_vs_fifo={m['mean_latency_ns'] / base['mean_latency_ns']:.3f};"
            f"inval_vs_fifo={m['invalidations'] / max(base['invalidations'], 1):.3f};"
            f"hit_rate={m['hit_rate']:.3f}",
        ))
    rows.append(Row(
        "fig14/paper_targets", 0.0,
        f"lifo_bw~{FIG14_TARGETS['bandwidth']};lifo_lat~{FIG14_TARGETS['latency']};"
        f"lifo_inval~{FIG14_TARGETS['invalidation']}",
    ))
    return rows
