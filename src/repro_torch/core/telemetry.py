"""Fabric telemetry: latency attribution, channel counters, windowed series,
streaming quantile sketches, SF protocol counters — PyTorch port.

The counterpart of ``repro.core.telemetry``, function for function and in
the same order.  The engine answers *when* every transaction moved; the
paper's §V studies need *why*: where a request's latency went, which
channel is the bottleneck, how tails evolve over a run.  This module is the
pure-observer instrumentation layer over ``(Hops, Channels, Schedule,
issue_ps)``:

  * **Latency attribution** (`attribute_latency`) — an exact partition of
    every request's end-to-end latency into join-wait stall, FCFS queueing
    wait, retraining stall, wire serialization, DRAM row-buffer extras and
    fixed post-latency, conservative by construction in int64 picoseconds
    (`conservation_residual`).  The retraining share comes from replaying
    one round from the resolved schedule (`engine.replay_round`: on the card
    one launch of the fused serve-round kernel; the schedule is never
    touched).
  * **Per-channel counters** (`channel_telemetry`) — payload and wire bytes,
    busy time, utilization, queue wait and peak backlog; `channel_blame`
    re-scatters the attribution onto the channels that charged it.
  * **Windowed series** (`windowed_series`) — busy fraction, completions and
    mean in-flight requests over a fixed bin grid.
  * **Streaming quantile sketch** (`QuantileSketch`) — a fixed-shape
    log-bucketed histogram (int64 ps, ~1.6 % relative error) with
    update / merge / query; `StreamTelemetry` folds windows of a stream.
  * **SF protocol counters** (`sf_telemetry`) — hit rate, BISnp fan-out
    histogram and InvBlk / writeback volume from a dense `SFEvents` log.

Every function computes on the device of the tensors it is given and writes
to none of its inputs.  Where the reference divides int64 by int64 (float64
under x64), the port casts both sides to float64 first: PyTorch's true
division of int64 tensors gives float32.  The reference ``jax.vmap``s these
functions over stacked sweep members; the port runs them on each member of
a `engine.simulate_stacked` result (`engine.member`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .engine import (Channels, Hops, Schedule, _channel_sum, replay_round,
                     resolve_device, to_host, wire_ser_ps)
from .snoop_filter import SFEvents, owner_count

INT64_MAX = torch.iinfo(torch.int64).max


def _flat_channels(hops: Hops, c: int, settled=None):
    """(occupied (K,), channel id or ``c`` when unoccupied (K,) int64)."""
    occ = hops.valid & (hops.nbytes > 0)
    if settled is not None:
        occ = occ & settled
    occ = occ.reshape(-1)
    return occ, torch.where(occ, hops.channel.reshape(-1).long(), c)


def _span(sched: Schedule, window):
    if window is None:
        return sched.arrive[:, 0].min(), sched.complete.max()
    dev = sched.complete.device
    return tuple(torch.as_tensor(t, dtype=torch.int64, device=dev)
                 for t in window)


# ---------------------------------------------------------------------------
# Latency attribution
# ---------------------------------------------------------------------------


class LatencyAttribution(NamedTuple):
    """Exact per-request partition of ``complete − issue`` (int64 ps).

    ``join_wait + queue_wait + retrain_stall + wire + row_extra + fixed ==
    total`` holds per row with zero residual.  Components:

    join_wait_ps      fork/join release stall (0 for non-waiters).
    queue_wait_ps     FCFS contention wait (turnaround gaps included),
                      *excluding* the retraining share below.
    retrain_stall_ps  grant delay attributable to link-down intervals
                      alone (stochastic reliability; 0 otherwise).
    wire_ps           wire serialization — flit quantization, expected
                      CRC-replay stretch and sampled replay bytes included.
    row_extra_ps      DRAM row-buffer hit/miss extras on service hops.
    fixed_ps          fixed post-hop latency.
    total_ps          ``complete − issue``.
    """

    join_wait_ps: torch.Tensor
    queue_wait_ps: torch.Tensor
    retrain_stall_ps: torch.Tensor
    wire_ps: torch.Tensor
    row_extra_ps: torch.Tensor
    fixed_ps: torch.Tensor
    total_ps: torch.Tensor


def _retrain_stall(hops: Hops, channels: Channels,
                   sched: Schedule) -> torch.Tensor:
    """(N, H) int64 grant delay of the link-down intervals alone: one
    replayed round (`engine.replay_round`) with retraining tables, else 0."""
    if hops.retrain_after_ps is None:
        return torch.zeros(hops.channel.shape, dtype=torch.int64,
                           device=hops.nbytes.device)
    return replay_round(hops, channels, sched)[2]


def attribute_latency(hops: Hops, channels: Channels, sched: Schedule,
                      issue_ps: torch.Tensor) -> LatencyAttribution:
    """Attribute every request's latency to its mechanism (see
    `LatencyAttribution`).  Reads the schedule, never recomputes it; with
    retraining tables it replays one round (`engine.replay_round`)."""
    return _attribute(hops, channels, sched, issue_ps,
                      _retrain_stall(hops, channels, sched))


def _attribute(hops, channels, sched, issue_ps, stall) -> LatencyAttribution:
    c = channels.bw_MBps.shape[0]
    valid = hops.valid
    occupied = valid & (hops.nbytes > 0)
    clip = hops.channel.long().clamp(0, c - 1)

    hop_wait = torch.where(valid, sched.start - sched.arrive[:, :-1], 0)
    hop_serv = torch.where(valid, sched.depart - sched.start, 0)
    wire = torch.where(
        occupied,
        wire_ser_ps(hops.nbytes, channels, clip,
                    extra_wire=hops.extra_wire_bytes),
        0,
    )
    retrain = torch.where(valid, stall, 0).sum(dim=1)
    join_wait = sched.arrive[:, 0] - issue_ps
    return LatencyAttribution(
        join_wait_ps=join_wait,
        queue_wait_ps=hop_wait.sum(dim=1) - retrain,
        retrain_stall_ps=retrain,
        wire_ps=wire.sum(dim=1),
        row_extra_ps=(hop_serv - wire).sum(dim=1),
        fixed_ps=torch.where(valid, hops.fixed_after_ps, 0).sum(dim=1),
        total_ps=sched.complete - issue_ps,
    )


def conservation_residual(att: LatencyAttribution) -> torch.Tensor:
    """Per-row conservation residual — exactly zero when the attribution
    partitions the latency (nonzero means a schedule that is not a fixpoint
    of the round map, or a telemetry bug)."""
    parts = (att.join_wait_ps + att.queue_wait_ps + att.retrain_stall_ps
             + att.wire_ps + att.row_extra_ps + att.fixed_ps)
    return att.total_ps - parts


# ---------------------------------------------------------------------------
# Per-channel counters
# ---------------------------------------------------------------------------


class ChannelTelemetry(NamedTuple):
    """Per-channel counters over one schedule, shape (C,) unless noted.

    payload_bytes   logical payload bytes transmitted (`Hops.is_payload`).
    wire_bytes      actual wire bytes: flit-quantized (+ sampled CRC-replay
                    bytes under stochastic reliability).
    busy_ps         total channel occupancy (serialization + row extras).
    wait_ps         total FCFS queue wait paid on the channel.
    utilization     ``busy_ps / window`` (float64).
    peak_backlog    max simultaneously queued items (arrived, not yet
                    granted; same-instant arrivals counted before grants).
    window_ps       () — observation window (defaults to first arrival →
                    last completion).
    """

    payload_bytes: torch.Tensor
    wire_bytes: torch.Tensor
    busy_ps: torch.Tensor
    wait_ps: torch.Tensor
    utilization: torch.Tensor
    peak_backlog: torch.Tensor
    window_ps: torch.Tensor


def hop_wire_bytes(hops: Hops, channels: Channels) -> torch.Tensor:
    """Actual wire bytes of every hop: flit quantization plus the sampled
    per-hop CRC-replay bytes (`Hops.extra_wire_bytes`); byte-exact channels
    pass logical bytes through.  Zero on invalid / zero-byte hops."""
    c = channels.bw_MBps.shape[0]
    occupied = hops.valid & (hops.nbytes > 0)
    clip = hops.channel.long().clamp(0, c - 1)
    wire = hops.nbytes
    if channels.flit_size is not None:
        fsize = channels.flit_size[clip]
        fpay = channels.flit_payload[clip].clamp_min(1)
        quant = ((hops.nbytes + fpay - 1) // fpay) * fsize
        if hops.extra_wire_bytes is not None:
            quant = quant + hops.extra_wire_bytes
        wire = torch.where(fsize > 0, quant, wire)
    return torch.where(occupied, wire, 0)


def channel_telemetry(hops: Hops, channels: Channels, sched: Schedule,
                      window: tuple | None = None) -> ChannelTelemetry:
    """Per-channel counters (see `ChannelTelemetry`)."""
    c = channels.bw_MBps.shape[0]
    n, h = hops.channel.shape
    k = n * h
    occupied, flat_c = _flat_channels(hops, c)

    def per_chan(x):
        return _channel_sum(flat_c, torch.where(occupied, x, 0), c)

    busy = per_chan((sched.depart - sched.start).reshape(k))
    wait = per_chan((sched.start - sched.arrive[:, :h]).reshape(k))
    payload = per_chan(torch.where(hops.is_payload.reshape(k),
                                   hops.nbytes.reshape(k), 0))
    wire = per_chan(hop_wire_bytes(hops, channels).reshape(k))

    # peak backlog: ±1 events (arrival +1, grant −1) stable-sorted by type,
    # then time, then channel, so each channel's events are contiguous with
    # same-instant arrivals before grants; every channel's deltas sum to
    # zero, so the global running sum is the per-channel backlog and a
    # per-channel max reads the peak (floored at 0 for idle channels)
    times = torch.cat([sched.arrive[:, :h].reshape(k),
                       sched.start.reshape(k)])
    chans2 = torch.cat([flat_c, flat_c])
    one = occupied.long()
    delta = torch.cat([one, -one])
    typ = torch.cat([torch.zeros(k, dtype=torch.int32, device=one.device),
                     torch.ones(k, dtype=torch.int32, device=one.device)])
    order = torch.argsort(typ, stable=True)
    order = order[torch.argsort(times[order], stable=True)]
    order = order[torch.argsort(chans2[order], stable=True)]
    backlog = torch.cumsum(delta[order], dim=0)
    peak = torch.zeros(c + 1, dtype=torch.int64, device=one.device)
    peak = peak.scatter_reduce_(0, chans2[order], backlog, "amax",
                                include_self=True)[:c]

    t0, t1 = _span(sched, window)
    span = (t1 - t0).clamp_min(1)
    return ChannelTelemetry(
        payload_bytes=payload, wire_bytes=wire, busy_ps=busy, wait_ps=wait,
        utilization=busy.double() / span.double(), peak_backlog=peak,
        window_ps=span,
    )


# ---------------------------------------------------------------------------
# Channel blame (aggregate bottleneck attribution)
# ---------------------------------------------------------------------------


class ChannelBlame(NamedTuple):
    """Aggregate per-channel blame: where the fleet's latency went.

    The per-request partition of `attribute_latency`, re-scattered onto the
    channel that charged each component.  Conservation:

        Σ queue + Σ retrain + Σ wire + Σ row_extra + join + fixed == total

    exactly (int64 ps; `blame_conservation_residual`).

    queue_ps      (C,) FCFS contention wait per channel (retraining share
                  excluded).
    retrain_ps    (C,) link-down stall per channel.
    wire_ps       (C,) serialization time per channel.
    row_extra_ps  (C,) row-buffer penalties per channel.
    join_ps       ()  fork/join release stall (channel-less).
    fixed_ps      ()  fixed post-hop latency (channel-less).
    total_ps      ()  Σ ``complete − issue``.
    """

    queue_ps: torch.Tensor
    retrain_ps: torch.Tensor
    wire_ps: torch.Tensor
    row_extra_ps: torch.Tensor
    join_ps: torch.Tensor
    fixed_ps: torch.Tensor
    total_ps: torch.Tensor


def channel_blame(hops: Hops, channels: Channels, sched: Schedule,
                  issue_ps: torch.Tensor) -> ChannelBlame:
    """Aggregate blame per channel (see `ChannelBlame`); the retraining
    share comes from the same replay as `attribute_latency`."""
    return _blame(hops, channels, sched, issue_ps,
                  _retrain_stall(hops, channels, sched))


def _blame(hops, channels, sched, issue_ps, stall) -> ChannelBlame:
    c = channels.bw_MBps.shape[0]
    n, h = hops.channel.shape
    k = n * h
    occupied, flat_c = _flat_channels(hops, c)
    clip = hops.channel.long().clamp(0, c - 1)

    def per_chan(x):
        return _channel_sum(flat_c, torch.where(occupied, x, 0), c)

    stall = stall.reshape(k)
    wait = (sched.start - sched.arrive[:, :h]).reshape(k)
    busy = (sched.depart - sched.start).reshape(k)
    wire_t = wire_ser_ps(hops.nbytes, channels, clip,
                         extra_wire=hops.extra_wire_bytes).reshape(k)
    return ChannelBlame(
        queue_ps=per_chan(wait - stall),
        retrain_ps=per_chan(stall),
        wire_ps=per_chan(wire_t),
        row_extra_ps=per_chan(busy - wire_t),
        join_ps=(sched.arrive[:, 0] - issue_ps).sum(),
        fixed_ps=torch.where(hops.valid, hops.fixed_after_ps, 0).sum(),
        total_ps=(sched.complete - issue_ps).sum(),
    )


def blame_conservation_residual(b: ChannelBlame) -> torch.Tensor:
    """() int64 — zero iff the blame table partitions the total latency."""
    parts = (b.queue_ps.sum() + b.retrain_ps.sum() + b.wire_ps.sum()
             + b.row_extra_ps.sum() + b.join_ps + b.fixed_ps)
    return b.total_ps - parts


# ---------------------------------------------------------------------------
# Windowed series
# ---------------------------------------------------------------------------


class WindowedSeries(NamedTuple):
    """Fixed-grid time series over one schedule (all shapes (n_bins,)).

    busy_ps        total channel occupancy inside each bin (all channels).
    busy_frac      ``busy_ps / (C · bin)`` — mean busy fraction (float64).
    completions    requests completing inside each bin.
    inflight       time-averaged in-flight requests per bin (float64).
    t0_ps, bin_ps  () — grid origin and bin width.
    """

    busy_ps: torch.Tensor
    busy_frac: torch.Tensor
    completions: torch.Tensor
    inflight: torch.Tensor
    t0_ps: torch.Tensor
    bin_ps: torch.Tensor


def windowed_series(hops: Hops, channels: Channels, sched: Schedule,
                    issue_ps: torch.Tensor, n_bins: int = 32,
                    window: tuple | None = None) -> WindowedSeries:
    """Bucket the schedule onto a fixed ``n_bins`` grid (see
    `WindowedSeries`).  Occupancy is split *exactly* across bins (partial
    overlap of a transmission with a bin counts its overlap), so the series
    sums to the channel totals.  The coverage is a dense (n_bins + 1) × K
    clip, as in the reference."""
    c = channels.bw_MBps.shape[0]
    t0, t1 = _span(sched, window)
    bin_ps = ((t1 - t0 + n_bins - 1) // n_bins).clamp_min(1)
    edges = t0 + bin_ps * torch.arange(n_bins + 1, dtype=torch.int64,
                                       device=bin_ps.device)

    def coverage(lo, hi):
        """Σ overlap of the [lo, hi) intervals with each bin, exactly."""
        dur = (hi - lo).clamp_min(0).reshape(-1)
        lo = lo.reshape(-1)
        # f(t) = Σ clip(t − lo, 0, dur); per-bin coverage = f(e+1) − f(e)
        f = torch.minimum((edges[:, None] - lo[None, :]).clamp_min(0),
                          dur[None, :]).sum(dim=1)
        return f[1:] - f[:-1]

    occupied = hops.valid & (hops.nbytes > 0)
    busy = coverage(torch.where(occupied, sched.start, 0),
                    torch.where(occupied, sched.depart, 0))
    infl = coverage(issue_ps, sched.complete)

    comp = sched.complete
    in_range = (comp >= t0) & (comp <= t1)
    idx = ((comp - t0) // bin_ps).clamp(0, n_bins - 1)
    completions = torch.zeros(n_bins, dtype=torch.int64,
                              device=comp.device).index_add_(
        0, idx, in_range.long())
    return WindowedSeries(
        busy_ps=busy,
        busy_frac=busy.double() / (c * bin_ps).double(),
        completions=completions,
        inflight=infl.double() / bin_ps.double(),
        t0_ps=t0, bin_ps=bin_ps,
    )


# ---------------------------------------------------------------------------
# Streaming quantile sketch (online p50/p99/p99.9)
# ---------------------------------------------------------------------------

SKETCH_SUB_BITS = 5                     # 32 sub-buckets per octave
_SKETCH_M = 1 << SKETCH_SUB_BITS
SKETCH_BINS = (64 - SKETCH_SUB_BITS) * _SKETCH_M
SKETCH_REL_ERROR = 1.0 / _SKETCH_M      # worst-case relative bucket width


class QuantileSketch(NamedTuple):
    """Streaming log-bucketed histogram over nonneg int64 picoseconds.

    HDR-histogram bucketing: values below 2^SKETCH_SUB_BITS are exact;
    above, each power-of-two octave splits into 2^SKETCH_SUB_BITS linear
    sub-buckets (≤ ~1.6 % relative error at the bucket midpoint).  State is
    one fixed-shape count vector plus exact min/max, and merging two
    sketches equals sketching the concatenation.
    """

    counts: torch.Tensor   # (SKETCH_BINS,) int64
    n: torch.Tensor        # () int64
    min_ps: torch.Tensor   # () int64 exact minimum (max int64 when empty)
    max_ps: torch.Tensor   # () int64 exact maximum (0 when empty)


def sketch_new(device="cuda") -> QuantileSketch:
    dev = resolve_device(device)
    return QuantileSketch(
        counts=torch.zeros(SKETCH_BINS, dtype=torch.int64, device=dev),
        n=torch.tensor(0, dtype=torch.int64, device=dev),
        min_ps=torch.tensor(INT64_MAX, dtype=torch.int64, device=dev),
        max_ps=torch.tensor(0, dtype=torch.int64, device=dev),
    )


def sketch_bin(values: torch.Tensor) -> torch.Tensor:
    """Bucket index of each value (negative values clamp to 0)."""
    v = torch.as_tensor(values).long().clamp_min(0)
    e = torch.zeros_like(v)
    for s in (32, 16, 8, 4, 2, 1):      # e = floor(log2(max(v, 1)))
        e = e + torch.where((v >> (e + s)) > 0, s, 0)
    small = v < _SKETCH_M
    sub = (v >> (e - SKETCH_SUB_BITS).clamp_min(0)) - _SKETCH_M
    return torch.where(small, v, (e - SKETCH_SUB_BITS + 1) * _SKETCH_M + sub)


def sketch_value(bins: torch.Tensor) -> torch.Tensor:
    """Representative (midpoint) value of each bucket index."""
    b = torch.as_tensor(bins).long()
    small = b < _SKETCH_M
    k = (b // _SKETCH_M).clamp_min(1)
    shift = k - 1                        # == octave − SKETCH_SUB_BITS
    lo = (_SKETCH_M + b % _SKETCH_M) << shift
    return torch.where(small, b, lo + ((torch.ones_like(shift) << shift) >> 1))


def sketch_update(sk: QuantileSketch, values: torch.Tensor,
                  mask: torch.Tensor | None = None) -> QuantileSketch:
    """Fold a batch of values (optionally masked) into the sketch."""
    dev = sk.counts.device
    v = torch.as_tensor(values, device=dev).long().reshape(-1)
    m = (torch.ones(v.shape, dtype=torch.bool, device=dev) if mask is None
         else torch.as_tensor(mask, device=dev).bool().reshape(-1))
    idx = torch.where(m, sketch_bin(v), 0)
    one = m.long()
    return QuantileSketch(
        counts=sk.counts.index_add(0, idx, one),
        n=sk.n + one.sum(),
        min_ps=torch.minimum(sk.min_ps, torch.where(m, v, INT64_MAX).min()),
        max_ps=torch.maximum(sk.max_ps, torch.where(m, v, 0).max()),
    )


def sketch_merge(a: QuantileSketch, b: QuantileSketch) -> QuantileSketch:
    return QuantileSketch(
        counts=a.counts + b.counts, n=a.n + b.n,
        min_ps=torch.minimum(a.min_ps, b.min_ps),
        max_ps=torch.maximum(a.max_ps, b.max_ps),
    )


def sketch_quantile(sk: QuantileSketch, q) -> torch.Tensor:
    """Estimate the q-quantile (scalar or vector ``q`` in [0, 1]).

    Returns the representative value of the bucket holding the
    ``ceil(q·n)``-th smallest sample, clamped to the exact observed
    [min, max] — so p0/p100 are exact and every estimate is within one
    bucket (≤ ~1.6 % relative) of a true sample quantile.  0 when empty.
    """
    q = torch.as_tensor(q, dtype=torch.float64, device=sk.counts.device)
    cum = torch.cumsum(sk.counts, dim=0)
    rank = torch.minimum(torch.ceil(q * sk.n).long().clamp_min(1),
                         sk.n.clamp_min(1))
    idx = torch.searchsorted(cum, rank.reshape(-1), side="left").reshape(
        rank.shape)
    val = torch.minimum(torch.maximum(
        sketch_value(idx.clamp_max(SKETCH_BINS - 1)), sk.min_ps), sk.max_ps)
    # ranks 1 and n are the exact observed order statistics
    val = torch.where(rank >= sk.n, sk.max_ps, val)
    val = torch.where(rank <= 1, sk.min_ps, val)
    return torch.where(sk.n > 0, val, 0)


def sketch_quantiles(sk: QuantileSketch,
                     qs=(0.5, 0.99, 0.999)) -> torch.Tensor:
    """The tail vector the studies gate on — default (p50, p99, p99.9)."""
    return sketch_quantile(sk, qs)


# ---------------------------------------------------------------------------
# Streaming fold (windowed simulation accumulator)
# ---------------------------------------------------------------------------


class StreamTelemetry(NamedTuple):
    """Running accumulator for windowed simulation — what a streaming
    driver carries instead of materializing per-window ``Schedule``s.

    Per-window contributions are masked to *settled* items / *retired*
    rows, so boundary-spanning rows fold exactly once and streaming totals
    equal the monolithic `channel_telemetry` counters; the blame components
    fold from the same masks (`stream_telemetry_finalize` derives the
    streamed `ChannelBlame`).

    payload_bytes/wire_bytes/busy_ps/wait_ps  (C,) int64 channel counters.
    retrain_ps    (C,) int64 link-down stall per channel (settled items).
    row_extra_ps  (C,) int64 row-buffer penalties per channel.
    join_ps       () int64 fork/join release stall.
    fixed_ps      () int64 fixed post-hop latency of settled items.
    sketch        latency `QuantileSketch` over retired requests.
    n_retired     () int64 requests retired so far.
    t0_ps/t1_ps   () int64 observation span (min issue / max completion of
                  retired requests; int64-max / 0 while empty).
    """

    sketch: QuantileSketch
    payload_bytes: torch.Tensor
    wire_bytes: torch.Tensor
    busy_ps: torch.Tensor
    wait_ps: torch.Tensor
    retrain_ps: torch.Tensor
    row_extra_ps: torch.Tensor
    join_ps: torch.Tensor
    fixed_ps: torch.Tensor
    n_retired: torch.Tensor
    t0_ps: torch.Tensor
    t1_ps: torch.Tensor


def stream_telemetry_new(n_channels: int, device="cuda") -> StreamTelemetry:
    dev = resolve_device(device)
    z = torch.zeros(n_channels, dtype=torch.int64, device=dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    return StreamTelemetry(
        sketch=sketch_new(dev), payload_bytes=z, wire_bytes=z, busy_ps=z,
        wait_ps=z, retrain_ps=z, row_extra_ps=z,
        join_ps=scalar(0), fixed_ps=scalar(0), n_retired=scalar(0),
        t0_ps=scalar(INT64_MAX), t1_ps=scalar(0),
    )


def stream_telemetry_fold(acc: StreamTelemetry, hops: Hops,
                          channels: Channels, sched: Schedule,
                          settled: torch.Tensor, retired: torch.Tensor,
                          latency_ps: torch.Tensor,
                          stall_ps: torch.Tensor,
                          gate_mask: torch.Tensor,
                          gate_wait_ps: torch.Tensor) -> StreamTelemetry:
    """Fold one resolved window into the accumulator.

    settled      (N, H) bool — items whose (start, depart) are final this
                 window, already AND-ed with validity.
    retired      (N,) bool — rows completing this window.
    latency_ps   (N,) int64 — ``complete − original issue`` per retired row.
    stall_ps     (N, H) int64 — per-item retraining stall from the window's
                 replay (zeros without retrain tables).
    gate_mask    (N,) bool — rows whose hop-0 gate became final this
                 window (each global row flagged once across the stream).
    gate_wait_ps (N,) int64 — ``arrive[:, 0] − original issue`` per row.
    """
    c = channels.bw_MBps.shape[0]
    n, h = hops.channel.shape
    k = n * h
    occupied, flat_c = _flat_channels(hops, c, settled)
    clip = hops.channel.long().clamp(0, c - 1)

    def per_chan(x):
        return _channel_sum(flat_c, torch.where(occupied, x, 0), c)

    busy_item = (sched.depart - sched.start).reshape(k)
    wire_time = wire_ser_ps(hops.nbytes, channels, clip,
                            extra_wire=hops.extra_wire_bytes).reshape(k)
    busy = per_chan(busy_item)
    wait = per_chan((sched.start - sched.arrive[:, :h]).reshape(k))
    payload = per_chan(torch.where(hops.is_payload.reshape(k),
                                   hops.nbytes.reshape(k), 0))
    wire = per_chan(hop_wire_bytes(hops, channels).reshape(k))
    retrain = per_chan(stall_ps.reshape(k))
    row_extra = per_chan(busy_item - wire_time)
    fixed = torch.where(settled, hops.fixed_after_ps, 0).sum()
    join = torch.where(gate_mask, gate_wait_ps, 0).sum()

    iss = sched.complete - latency_ps
    return StreamTelemetry(
        sketch=sketch_update(acc.sketch, latency_ps, mask=retired),
        payload_bytes=acc.payload_bytes + payload,
        wire_bytes=acc.wire_bytes + wire,
        busy_ps=acc.busy_ps + busy,
        wait_ps=acc.wait_ps + wait,
        retrain_ps=acc.retrain_ps + retrain,
        row_extra_ps=acc.row_extra_ps + row_extra,
        join_ps=acc.join_ps + join,
        fixed_ps=acc.fixed_ps + fixed,
        n_retired=acc.n_retired + retired.long().sum(),
        t0_ps=torch.minimum(acc.t0_ps,
                            torch.where(retired, iss, INT64_MAX).min()),
        t1_ps=torch.maximum(acc.t1_ps,
                            torch.where(retired, sched.complete, 0).max()),
    )


def stream_telemetry_finalize(acc: StreamTelemetry,
                              qs=(0.5, 0.99, 0.999)) -> dict:
    """Host-side summary of a finished (or in-progress) stream fold, as
    numpy arrays and Python ints.

    The ``blame`` entry is the streamed `ChannelBlame` decomposition —
    queue wait is the folded wait minus the retraining share, wire time is
    folded busy minus row extras.  ``utilization`` is float64 (numpy's
    int64 / int true division), as in the reference.
    """
    span = max(int(acc.t1_ps) - int(acc.t0_ps), 1)
    wait = to_host(acc.wait_ps)
    busy = to_host(acc.busy_ps)
    retrain = to_host(acc.retrain_ps)
    row_extra = to_host(acc.row_extra_ps)
    return {
        "n_retired": int(acc.n_retired),
        "quantiles_ps": to_host(sketch_quantiles(acc.sketch, qs)),
        "payload_bytes": to_host(acc.payload_bytes),
        "wire_bytes": to_host(acc.wire_bytes),
        "busy_ps": busy,
        "wait_ps": wait,
        "utilization": busy / span,
        "span_ps": span,
        "blame": {
            "queue_ps": wait - retrain,
            "retrain_ps": retrain,
            "wire_ps": busy - row_extra,
            "row_extra_ps": row_extra,
            "join_ps": int(acc.join_ps),
            "fixed_ps": int(acc.fixed_ps),
        },
    }


# ---------------------------------------------------------------------------
# Snoop-filter protocol counters
# ---------------------------------------------------------------------------


class SFTelemetry(NamedTuple):
    """Protocol-decision counters from a dense `SFEvents` log.

    hit_rate      () float64 — local-cache hit fraction.
    fanout_hist   (R+1,) int64 — histogram of per-request snooped-owner
                  counts (index = popcount of ``bisnp_mask``).
    bisnp_legs    () int64 — total BISnp legs (Σ owner popcounts).
    invblk_lines  () int64 — lines invalidated by InvBlk/conflict flows.
    wb_lines      () int64 — dirty lines written back.
    """

    hit_rate: torch.Tensor
    fanout_hist: torch.Tensor
    bisnp_legs: torch.Tensor
    invblk_lines: torch.Tensor
    wb_lines: torch.Tensor


def sf_telemetry(events: SFEvents, n_requesters: int) -> SFTelemetry:
    owners = owner_count(events.bisnp_mask).long()
    hist = torch.zeros(n_requesters + 1, dtype=torch.int64,
                       device=owners.device).index_add_(
        0, owners.clamp(0, n_requesters), torch.ones_like(owners))
    t = events.cache_hit.shape[0]
    # the reference jits this function with T static, and XLA compiles its
    # division by that constant into a product with the reciprocal (one ulp
    # off the quotient at times); the port takes the same product
    return SFTelemetry(
        hit_rate=events.cache_hit.sum().double() * (1.0 / max(t, 1)),
        fanout_hist=hist,
        bisnp_legs=owners.sum(),
        invblk_lines=events.inv_lines.long().sum(),
        wb_lines=events.wb_lines.long().sum(),
    )


# ---------------------------------------------------------------------------
# Convenience aggregation
# ---------------------------------------------------------------------------


def fabric_metrics(hops: Hops, channels: Channels, sched: Schedule,
                   issue_ps: torch.Tensor, n_bins: int = 32,
                   check: bool = True) -> dict:
    """One-call telemetry bundle: attribution + blame + channel counters +
    windowed series + a latency sketch.  ``check=True`` raises if either
    conservation invariant fails; both residuals come back in one host
    readback.  The retraining round is replayed once, for both the
    attribution and the blame."""
    stall = _retrain_stall(hops, channels, sched)
    att = _attribute(hops, channels, sched, issue_ps, stall)
    blame = _blame(hops, channels, sched, issue_ps, stall)
    if check:
        bad_att, bad_blame = torch.stack([
            conservation_residual(att).abs().max(),
            blame_conservation_residual(blame)]).tolist()
        if bad_att != 0:
            raise AssertionError(
                f"latency attribution violates conservation by {bad_att} "
                "ps — the schedule is not a fixpoint of the round map (did "
                "it converge?) or telemetry has a bug")
        if bad_blame != 0:
            raise AssertionError(
                f"channel blame violates conservation by {bad_blame} ps")
    sk = sketch_update(sketch_new(att.total_ps.device), att.total_ps)
    return {
        "attribution": att,
        "blame": blame,
        "channels": channel_telemetry(hops, channels, sched),
        "series": windowed_series(hops, channels, sched, issue_ps,
                                  n_bins=n_bins),
        "latency_sketch": sk,
        "latency_quantiles_ps": sketch_quantiles(sk),
        "rounds": sched.rounds,
        "converged": sched.converged,
    }
