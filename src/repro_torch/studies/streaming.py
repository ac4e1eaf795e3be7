"""Streaming windowed engine: million-request traces at flat memory, on the
port.

The counterpart of ``benchmarks/bench_streaming.py``: a bursty open-loop
demand trace driven through `core.streaming.simulate_stream` — fixed-size
windows resolved from the carried fabric state on the card, folded into the
running `StreamTelemetry` instead of materializing O(N·H) schedules.  Quick
mode streams 60k requests; full mode streams 1.2M — the paper's §V-E trace
scale — through 64k-row windows.  Chunks are built on the tables' device.

Acceptance gates (AssertionErrors):

  * exactness — a small streamed run equals the monolithic engine bit for
    bit (every item's start/depart/arrive, every row's completion), and so
    do its streamed blame and peak backlog;
  * conservation — every request retires exactly once;
  * flat memory — peak in-flight rows at window edges stays a small
    fraction of the window (the whole point of windowing);
  * ordering — streamed tail quantiles satisfy p50 <= p99 <= p99.9.

Rows carry ``meta`` (window count, carried-row peak, oracle fallbacks,
tail quantiles) as the reference's do.  With a `StudyLog`, the headline
stream's host seconds per window step (`core.streaming.STEPS`) land in
``log.seconds`` as ``stream.<step>``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.engine import Channels, Hops, resolve_device, simulate, to_host
from ..core.streaming import (STEPS, StreamState, simulate_stream,
                              stream_windows)
from ..core.telemetry import channel_blame, channel_telemetry
from ..core.traces import arrival_times
from ..core.verify import assert_valid
from .common import Row, StudyLog, Timer

N_LANES = 4
SVC = N_LANES                 # endpoint service channel
MEAN_GAP_PS = 6000            # ~70% endpoint utilization (stable queue)
H = 3                         # request -> service -> response


def _channels(device="cuda") -> Channels:
    dev = resolve_device(device)
    bw = np.full(N_LANES + 1, 64_000, np.int64)
    bw[SVC] = 128_000
    turn = np.zeros(N_LANES + 1, np.int64)
    turn[:N_LANES] = 1500                      # half-duplex lanes
    rh = np.zeros(N_LANES + 1, np.int64)
    rm = np.zeros(N_LANES + 1, np.int64)
    rh[SVC], rm[SVC] = 1000, 9000              # row-managed endpoint
    return Channels(*(torch.tensor(a, device=dev) for a in (bw, turn, rh, rm)))


def _chunk(lo: int, hi: int, t0: int, seed: int, device="cuda"):
    """One chunk of the open-loop trace, built on ``device``: each request
    runs request -> endpoint service -> response on its lane, bursty
    arrivals (the seeded draws are numpy's, as in the reference)."""
    dev = resolve_device(device)
    idx = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    m = idx.shape[0]
    lane = (idx % N_LANES).int()
    mix = (idx * 2654435761) & 0xFFFFFFFF      # cheap deterministic hash
    chan = torch.stack([lane, torch.full_like(lane, SVC), lane], 1)
    small = torch.full_like(idx, 64)
    nbytes = torch.stack([small, torch.where(mix % 3 == 0, 256, small),
                          torch.where(mix % 5 == 0, 256, small)], 1)
    zeros = torch.zeros(m, dtype=torch.int8, device=dev)
    dirn = torch.stack([zeros, zeros, torch.ones_like(zeros)], 1)
    row = torch.full((m, H), -1, dtype=torch.int32, device=dev)
    row[:, 1] = ((idx >> 2) % 7).int()
    fixed = torch.full((m, H), 2000, dtype=torch.int64, device=dev)
    valid = torch.ones((m, H), dtype=torch.bool, device=dev)
    hops = Hops(chan, nbytes, dirn, row, fixed, valid, valid.clone())
    issue = t0 + arrival_times(m, mean_gap_ps=MEAN_GAP_PS, pattern="bursty",
                               seed=seed)
    return hops, torch.tensor(issue, device=dev)


def _trace(n: int, chunk: int, device="cuda"):
    t0 = 0
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        yield _chunk(lo, hi, t0, seed=lo, device=device)
        t0 += (hi - lo) * MEAN_GAP_PS


def _blame_equal(sb: dict, mb, what: str = "differs from channel_blame"):
    """A streamed blame fold (`StreamResult.summary()["blame"]`) against
    monolithic `channel_blame`, bit for bit."""
    for key in ("queue_ps", "retrain_ps", "wire_ps", "row_extra_ps"):
        assert np.array_equal(np.asarray(sb[key]),
                              to_host(getattr(mb, key))), \
            f"streamed blame {key} {what}"
    assert int(sb["join_ps"]) == int(mb.join_ps), f"streamed join_ps {what}"
    assert int(sb["fixed_ps"]) == int(mb.fixed_ps), \
        f"streamed fixed_ps {what}"


def stream_matches_monolithic(hops: Hops, ch: Channels, issue, mono, res,
                              what: str = "stream"):
    """A `simulate_stream` result with ``collected`` against the monolithic
    schedule ``mono`` of the same tables, bit for bit: every valid item
    folded exactly once with its start, depart and arrive, every row
    retired once with its completion, every gated first-hop arrival; the
    streamed blame and peak backlog against `channel_blame` and
    `channel_telemetry` of ``mono``.  Raises AssertionError."""
    col = res.collected
    r = col["item_row"].astype(np.int64)
    k = col["item_hop"].astype(np.int64)
    valid = to_host(hops.valid)
    n, h = valid.shape
    assert np.array_equal(np.sort(r * h + k), np.flatnonzero(valid)), \
        f"{what}: settled items folded more or less than once"
    for key, full in (("item_start", mono.start), ("item_depart", mono.depart),
                      ("item_arrive", mono.arrive)):
        assert np.array_equal(col[key], to_host(full)[r, k]), \
            f"{what}: streamed {key} differs from the monolithic run"
    rr = col["row_id"].astype(np.int64)
    assert np.array_equal(np.sort(rr), np.arange(n)), \
        f"{what}: rows retired more or less than once"
    assert np.array_equal(col["row_complete"], to_host(mono.complete)[rr]), \
        f"{what}: streamed completions differ from the monolithic run"
    gr = col["gate_row"].astype(np.int64)
    assert np.array_equal(col["gate_arrive0"], to_host(mono.arrive)[gr, 0]), \
        f"{what}: streamed gated arrivals differ from the monolithic run"
    s = res.summary()
    _blame_equal(s["blame"], channel_blame(hops, ch, mono, issue),
                 f"({what}) differs from monolithic channel_blame")
    peak = to_host(channel_telemetry(hops, ch, mono).peak_backlog)
    assert np.array_equal(np.asarray(s["peak_backlog"]), peak), \
        f"{what}: streamed peak_backlog differs from channel_telemetry"


def _blame_json(blame: dict) -> dict:
    """A streamed blame dict as JSON-ready Python ints and lists."""
    return {key: (int(v) if np.ndim(v) == 0 else np.asarray(v).tolist())
            for key, v in blame.items()}


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    log = log or StudyLog()
    rows: list[Row] = []
    with log.phase("build"):
        ch = _channels(device)
        small_h, small_i = _chunk(0, 2000, 0, seed=0, device=device)

    # gate: streamed == monolithic, bit for bit, at test scale, schedule,
    # blame fold and peak backlog ------------------------------------------
    assert_valid(small_h, ch, small_i)
    mono = log.simulate("equivalence_gate/monolithic", simulate, small_h, ch,
                        small_i)
    assert mono.converged
    out = simulate_stream(stream_windows(small_h, small_i, 256), ch,
                          collect_schedule=True)
    stream_matches_monolithic(small_h, ch, small_i, mono, out,
                              "equivalence gate")
    small_sum = out.summary()
    assert small_sum["windows_converged"] == out.windows

    # the headline run: flat-memory windowed streaming ---------------------
    n = 60_000 if quick else 1_200_000
    window = 8_192 if quick else 65_536
    state = StreamState(ch)
    state.sync = log.sync
    with Timer() as t, log.phase("execute"):
        res = simulate_stream(_trace(n, window, device), ch, state)
    s = res.summary()
    for step in STEPS:
        log.seconds[f"stream.{step}"] = state.seconds[step]

    # gates ----------------------------------------------------------------
    assert s["n_retired"] == n, \
        f"retired {s['n_retired']} of {n} requests"
    assert res.carried_peak <= max(window // 8, 64), \
        f"carried rows {res.carried_peak} not small vs window {window}"
    p50, p99, p999 = (int(q) for q in s["quantiles_ps"])
    assert 0 < p50 <= p99 <= p999, "tail quantiles out of order"
    util = float(np.max(s["utilization"]))
    assert 0.0 < util <= 1.0, f"utilization {util} out of (0, 1]"

    host_phases = {k: round(v, 6) for k, v in sorted(log.seconds.items())}
    req_per_s = n / (t.us / 1e6)
    rows.append(Row(
        "streaming/windowed_trace", t.us,
        f"n={n};window={window};req_per_s={req_per_s:.0f};"
        f"p50={p50 / 1e3:.0f}ns;p99={p99 / 1e3:.0f}ns;"
        f"p999={p999 / 1e3:.0f}ns",
        meta={"n_requests": n, "window_rows": window,
              "windows": res.windows, "carried_peak": res.carried_peak,
              "oracle_windows": res.oracle_windows,
              "quantiles_ps": [p50, p99, p999],
              "max_utilization": util,
              "span_ps": s["span_ps"],
              # per-window fixpoint diagnostics + streamed observability
              "rounds_sum": s["rounds_sum"],
              "rounds_max": s["rounds_max"],
              "windows_converged": s["windows_converged"],
              "peak_backlog": np.asarray(s["peak_backlog"]).tolist(),
              "blame": _blame_json(s["blame"]),
              "host_phases": host_phases},
    ))
    rows.append(Row(
        "streaming/equivalence_gate", 0.0,
        f"rows=2000;windows={out.windows};bitexact=True;blame=bitexact;"
        f"peak_backlog=bitexact",
        meta={"windows": out.windows, "carried_peak": out.carried_peak,
              "rounds_sum": small_sum["rounds_sum"],
              "rounds_max": small_sum["rounds_max"],
              "windows_converged": small_sum["windows_converged"]},
    ))
    return rows
