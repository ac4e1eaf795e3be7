"""Tensorized transaction schedule engine (ESF device layer), PyTorch port.

The counterpart of ``repro.core.engine``.  Transaction-level simulation is a
fixpoint of dense tensor ops:

  * Every transaction is a row of hop records ``(channel, bytes, direction,
    row, fixed_after)`` (request hops, an endpoint-service hop, response
    hops).
  * FCFS contention per channel is a *segmented tropical scan*: with items
    sorted by (channel, arrival, tiebreak), within a channel segment

        start_i  = max(arrive_i, depart_{i-1} [+ turnaround if direction flip])
        depart_i = start_i + serialize_i [+ row-buffer penalty]

  * Arrival times satisfy ``arrive[p, h+1] = depart[p, h] + fixed_after[p, h]``.
    Arrivals start from the contention-free schedule (a lower bound) and the
    engine iterates sort→scan→propagate until the integer fixpoint is
    reached.  Delays only ever grow toward the true FCFS schedule, whose
    exactness is checked against the event-driven oracle (`core.ref_des`).

All times are int64 **picoseconds** and all sizes int64 bytes, so schedules
are exact and tie-breaking (by flat item index = packet-major order) is
deterministic and identical to the oracle and to the JAX reference.

The serve sweep of each round runs as the (max,+) affine-map scan of
`kernels.serve_round`: a hand-written CUDA kernel when the tensors lie on the
card, its plain PyTorch version when they lie on the CPU.  The tensors'
device picks the path; there is no option for it.

Not ported from the reference, by design:

  * the per-item ``lax.scan`` serve formulation (``repro.core.engine``
    ``_one_round`` with ``impl="scan"``) — the kernel formulation, which the
    reference pins bit-equal to it, is the port's only serve path;
  * ``SimOptions.use_kernel`` — the device of the tensors picks the path;
  * the deprecated per-call kwargs (``max_rounds=``, ``check=True``, ...).

Sweeps: the reference ``jax.vmap``s `simulate` over stacked tables.  The
port's counterpart is `simulate_stacked`, which lays the members side by
side on disjoint channel and row ids and resolves them all with one sort,
one serve-scan launch and one scatter per round.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.serve_round.ops import serve_round

PS_PER_S = 1_000_000_000_000


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; a CUDA device without a card raises
    (the port never carries on on the CPU when it was asked for the GPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA card is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def to_device(x, device) -> torch.Tensor:
    """Copy a host array (numpy or any tensor) onto ``device``, keeping its
    dtype; the copy never aliases the caller's buffer."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, copy=True)
    return torch.from_numpy(np.array(x)).to(device)


def to_host(x) -> np.ndarray:
    """numpy array of a host array or of a tensor on any device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ser_ps(nbytes, bw_MBps):
    """Exact integer serialization time: bytes / (MB/s) in picoseconds.

    bytes * 1e6 // MBps  ==  bytes * 1e12 // (MBps * 1e6) exactly, with an
    int64 overflow headroom of ~9 TB per packet instead of ~9 MB."""
    return (nbytes * 1_000_000) // bw_MBps


def wire_ser_ps(nbytes, ch: "Channels", chan_clipped, extra_wire=None):
    """Serialization time of ``nbytes`` logical bytes on their channels,
    honouring the link-layer flit tables (`core.link_layer`):

      * flit channels transmit whole flits — ceil(bytes/payload) * size wire
        bytes — and stretch by the expected Go-Back-N CRC-replay overhead
        ``(1 + replay_ppm/1e6)``, floored to exact integer picoseconds;
      * byte-exact channels (flit_size 0, or Channels with no flit tables)
        keep the seed formula bit-for-bit;
      * ``extra_wire`` (stochastic reliability, `Hops.extra_wire_bytes`)
        adds the build-time-sampled CRC-replay wire bytes of each item.
    """
    bw = ch.bw_MBps[chan_clipped]
    base = ser_ps(nbytes, bw)
    if ch.flit_size is None:
        return base
    fsize = ch.flit_size[chan_clipped]
    fpay = torch.clamp_min(ch.flit_payload[chan_clipped], 1)
    wire = ((nbytes + fpay - 1) // fpay) * fsize
    if extra_wire is not None:
        wire = wire + extra_wire
    fser = ser_ps(wire, bw)
    if ch.replay_ppm is not None:
        ppm = ch.replay_ppm[chan_clipped]
        # floor(fser * (1e6 + ppm) / 1e6), decomposed so the product never
        # exceeds int64 even with ppm at the MAX_REPLAY_PPM clamp (1e9):
        # identical to the oracle's arbitrary-precision formula for any
        # fser below ~9.2e15 ps
        scale = 1_000_000 + ppm
        q, r = fser // 1_000_000, fser % 1_000_000
        fser = q * scale + (r * scale) // 1_000_000
    return torch.where(fsize > 0, fser, base)


class Channels(NamedTuple):
    """Static per-channel tables (from `FabricGraph`), all on one device.

    The three optional flit tables are the link-layer lowering contract of
    `core.link_layer`: a channel with ``flit_size > 0`` serializes whole
    flits and pays the expected CRC-replay overhead ``replay_ppm``.
    ``None`` — the seed layout — reproduces byte-exact serialization.
    """

    bw_MBps: torch.Tensor        # (C,) int64
    turnaround_ps: torch.Tensor  # (C,) int64, half-duplex direction-flip cost
    row_hit_ps: torch.Tensor     # (C,) int64 extra when row matches
    row_miss_ps: torch.Tensor    # (C,) int64 extra when row differs / cold
    flit_size: torch.Tensor | None = None     # (C,) int64, 0 = byte-exact
    flit_payload: torch.Tensor | None = None  # (C,) int64
    replay_ppm: torch.Tensor | None = None    # (C,) int64


class Hops(NamedTuple):
    """Per-transaction hop table, shape (N, H); padded hops have valid=False.

    ``extra_wire_bytes`` / ``retrain_after_ps`` carry the stochastic
    link-reliability samples; ``join_id`` / ``join_wait`` / ``join_arity``
    are the fork/join primitive (a waiter row issues at ``max(issue, max
    completion of its group's contributors)``).  See ``repro.core.engine.Hops``
    for the full contract, which this port keeps field for field.
    """

    channel: torch.Tensor      # (N, H) int32
    nbytes: torch.Tensor       # (N, H) int64 serialized bytes on this hop
    direction: torch.Tensor    # (N, H) int8  0/1 for half-duplex channels
    row: torch.Tensor          # (N, H) int32 DRAM row id, -1 = not row-managed
    fixed_after_ps: torch.Tensor  # (N, H) int64 latency after transmission
    is_payload: torch.Tensor   # (N, H) bool — payload (vs header) bytes
    valid: torch.Tensor        # (N, H) bool
    extra_wire_bytes: torch.Tensor | None = None   # (N, H) int64
    retrain_after_ps: torch.Tensor | None = None   # (N, H) int64
    join_id: torch.Tensor | None = None     # (N,) int32 group fed, -1 = none
    join_wait: torch.Tensor | None = None   # (N,) int32 group gating issue
    join_arity: torch.Tensor | None = None  # (N,) int32 contributors expected


class Schedule(NamedTuple):
    """Resolved schedule plus the convergence diagnostics ``rounds`` /
    ``converged`` / ``residual_ps`` (host Python values: the fixpoint loop
    reads the residual back every round anyway)."""

    arrive: torch.Tensor    # (N, H+1) arrival per hop; [:, H] = completion
    start: torch.Tensor     # (N, H) channel grant time
    depart: torch.Tensor    # (N, H) transmission end
    complete: torch.Tensor  # (N,)
    rounds: int             # iterations used
    converged: bool
    residual_ps: int = 0    # last round's max |Δarrive|


class StreamCarry(NamedTuple):
    """Per-channel frontier state carried into a window (streaming runs).

    depart_ps      (C,) int64 — busy-until of the last settled serving item
                   (0 = channel never served).
    last_dir       (C,) int8 — its direction (-1 = none: no turnaround due).
    last_row       (C,) int32 — last settled DRAM row (-2 = cold).
    down_until_ps  (C,) int64 — max retraining down interval (0 = link up).
    join_seed_ps   (N,) int64 or None — carried fork/join group maxes.
    """

    depart_ps: torch.Tensor
    last_dir: torch.Tensor
    last_row: torch.Tensor
    down_until_ps: torch.Tensor
    join_seed_ps: torch.Tensor | None = None


def empty_carry(n_channels: int, n_rows: int | None = None,
                device="cuda") -> StreamCarry:
    """A cold carry: seeding `simulate` with it is bit-identical to no carry."""
    dev = resolve_device(device)
    return StreamCarry(
        depart_ps=torch.zeros(n_channels, dtype=torch.int64, device=dev),
        last_dir=torch.full((n_channels,), -1, dtype=torch.int8, device=dev),
        last_row=torch.full((n_channels,), -2, dtype=torch.int32, device=dev),
        down_until_ps=torch.zeros(n_channels, dtype=torch.int64, device=dev),
        join_seed_ps=(None if n_rows is None else
                      torch.zeros(n_rows, dtype=torch.int64, device=dev)),
    )


_CHECK_MODES = ("off", "static", "oracle")


@dataclasses.dataclass(frozen=True)
class SimOptions:
    """One options surface for the simulation entry points.

    max_rounds  fixpoint round budget; 0 (default) = the computed
                join-depth-aware `round_bound`.
    check       "off"    — no oracle fallback in `simulate_auto`;
                "oracle" — fall back to the event-driven `ref_des` oracle
                           when the fixpoint reports non-convergence;
                "static" — also run the fabric-IR verifier (`verify`) on
                           the lowered triple first and raise
                           `verify.VerifyError` on any finding.
    damping     damped Picard iteration of the coupled coherence fixpoint
                (no entry point of this slice reads it).
    """

    max_rounds: int = 0
    check: str = "oracle"
    damping: bool = False

    def __post_init__(self):
        if self.check not in _CHECK_MODES:
            raise ValueError(
                f"SimOptions.check must be one of {_CHECK_MODES}, "
                f"got {self.check!r}")


def round_bound(hops: Hops) -> int:
    """Join-depth-aware fixpoint round budget for a lowered `Hops` table —
    ``(join_depth + 1) * (3*H + 8)`` (see `verify.round_bound`).  On
    stacked tables (a leading member axis, `simulate_stacked`) it is the
    maximum over the members."""
    from . import verify  # host-side helper module

    h = int(hops.channel.shape[-1])
    if hops.join_id is None or hops.join_wait is None:
        return verify.round_bound(h)
    jid, jw = to_host(hops.join_id), to_host(hops.join_wait)
    return max(verify.round_bound(h, j, w)
               for j, w in zip(jid.reshape(-1, jid.shape[-1]),
                               jw.reshape(-1, jw.shape[-1])))


def _round_inputs(hops: Hops, ch: Channels, arrive,
                  carry: StreamCarry | None = None):
    """Sort one round's items by (channel, arrival, flat index) and gather
    the per-item inputs of `kernels.serve_round.ops.serve_round`.

    Returns ``(order, args)``: the sort permutation and the fifteen sorted
    (K,) operands, in `serve_round`'s positional order."""
    n, h = hops.channel.shape
    k = n * h
    c = ch.bw_MBps.shape[0]
    flat_arrive = arrive[:, :h].reshape(k)
    flat_chan = hops.channel.reshape(k).long()
    flat_valid = hops.valid.reshape(k)
    # push invalid items to a dummy tail segment so they never contend
    sort_chan = torch.where(flat_valid, flat_chan, c)

    # lexsort by (channel, arrive, flat index): two stable passes
    order = torch.argsort(flat_arrive, stable=True)
    order = order[torch.argsort(sort_chan[order], stable=True)]

    s_chan = flat_chan[order]
    # padded hops (channel -1) only need some in-range table entry: their
    # values never reach an output
    chan_clipped = s_chan.clamp(0, c - 1)
    s_valid = flat_valid[order]
    s_arrive = flat_arrive[order]
    s_bytes = hops.nbytes.reshape(k)[order]
    s_extra = (hops.extra_wire_bytes.reshape(k)[order]
               if hops.extra_wire_bytes is not None else None)
    s_retrain = (hops.retrain_after_ps.reshape(k)[order]
                 if hops.retrain_after_ps is not None
                 else torch.zeros_like(s_arrive))
    if carry is not None:
        sd = (carry.depart_ps[chan_clipped], carry.last_dir[chan_clipped],
              carry.last_row[chan_clipped], carry.down_until_ps[chan_clipped])
    else:
        sd = (torch.zeros_like(s_arrive),
              torch.full_like(s_arrive, -1, dtype=torch.int8),
              torch.full_like(s_arrive, -2, dtype=torch.int32),
              torch.zeros_like(s_arrive))
    args = (
        s_chan,
        s_valid & (s_bytes > 0),                        # serving
        s_valid & (s_bytes == 0) & (s_retrain > 0),     # link-down marker
        s_arrive,
        hops.direction.reshape(k)[order],
        hops.row.reshape(k)[order],
        wire_ser_ps(s_bytes, ch, chan_clipped, extra_wire=s_extra),
        ch.turnaround_ps[chan_clipped],
        ch.row_hit_ps[chan_clipped],
        ch.row_miss_ps[chan_clipped],
        s_retrain,
    ) + sd
    return order, args


def _one_round(hops: Hops, ch: Channels, issue_ps, arrive, with_stalls=False,
               carry: StreamCarry | None = None):
    """One sort→serve-scan→propagate pass.  arrive: (N, H+1).

    Returns ``(new_arrive, start, depart)``, plus the per-item retraining
    stall share of each grant delay when ``with_stalls`` (telemetry
    replay).  ``carry`` seeds every segment head with the channel's carried
    frontier instead of a cold channel."""
    order, args = _round_inputs(hops, ch, arrive, carry)
    s_start, s_depart, s_stall = serve_round(*args)
    return _scatter_round(hops, issue_ps, order, s_start, s_depart,
                          s_stall if with_stalls else None)


def _scatter_round(hops: Hops, issue_ps, order, s_start, s_depart, s_stall):
    """Scatter sorted per-item grants back to (N, H) and propagate exact
    arrivals (padded hops pass the previous arrival through)."""
    n, h = hops.channel.shape
    start = torch.empty_like(s_start).index_copy_(0, order, s_start).view(n, h)
    depart = torch.empty_like(s_depart).index_copy_(
        0, order, s_depart).view(n, h)

    # arrive[:, j+1] = depart + fixed of the last valid hop <= j, else the
    # issue time: a forward fill by running max of valid hop indices
    cols = torch.arange(h, device=depart.device).expand(n, h)
    last = torch.cummax(torch.where(hops.valid, cols, -1), dim=1).values
    filled = torch.gather(depart + hops.fixed_after_ps, 1, last.clamp_min(0))
    issue_col = issue_ps[:, None]
    new_arrive = torch.cat(
        [issue_col, torch.where(last >= 0, filled, issue_col)], dim=1)
    if s_stall is not None:
        stall = torch.empty_like(s_stall).index_copy_(
            0, order, s_stall).view(n, h)
        return new_arrive, start, depart, stall
    return new_arrive, start, depart


def _join_gate(hops: Hops, issue_ps, arrive, join_seed=None):
    """Fork/join issue gating: the effective issue time of a waiter row is
    ``max(issue, max completion of its group's contributors)``, resolved as a
    scatter-max over the current iterate's completion column (exact at the
    fixpoint; join delays only grow).  ``join_seed`` folds in the carried
    completions of contributors that retired in earlier windows."""
    n, h = hops.channel.shape
    comp = arrive[:, h]
    contrib = hops.join_id >= 0
    gmax = torch.zeros(n, dtype=torch.int64, device=comp.device)
    gmax.scatter_reduce_(0, torch.where(contrib, hops.join_id, 0).long(),
                         torch.where(contrib, comp, 0), reduce="amax",
                         include_self=True)
    if join_seed is not None:
        gmax = torch.maximum(gmax, join_seed)
    wait = hops.join_wait >= 0
    gate = gmax[hops.join_wait.long().clamp(0, n - 1)]
    return torch.where(wait, torch.maximum(issue_ps, gate), issue_ps)


def _initial_arrive(hops: Hops, channels: Channels, issue_ps):
    """Contention-free lower bound (sampled replay stretch included:
    retraining stalls and join gates only ever delay items)."""
    n, _ = hops.channel.shape
    ser0 = wire_ser_ps(
        hops.nbytes, channels,
        hops.channel.long().clamp(0, channels.bw_MBps.shape[0] - 1),
        extra_wire=hops.extra_wire_bytes)
    step = torch.where(hops.valid, ser0 + hops.fixed_after_ps, 0)
    zero = torch.zeros((n, 1), dtype=torch.int64, device=step.device)
    return issue_ps[:, None] + torch.cat([zero, torch.cumsum(step, 1)], 1)


def simulate(hops: Hops, channels: Channels, issue_ps: torch.Tensor,
             options: SimOptions | None = None, *,
             carry: StreamCarry | None = None) -> Schedule:
    """Resolve the exact FCFS schedule of all transactions.

    Runs on the device the tensors lie on.  The budget is
    ``options.max_rounds`` or, when 0, the computed `round_bound`; the loop
    stops early on the first round whose arrivals did not change, reading
    the residual back to the host each round.  ``rounds`` / ``converged`` /
    ``residual_ps`` equal the JAX reference's ``lax.while_loop`` values.
    """
    opts = options if options is not None else SimOptions()
    budget = opts.max_rounds if opts.max_rounds > 0 else round_bound(hops)
    has_join = hops.join_id is not None
    join_seed = carry.join_seed_ps if carry is not None else None

    n, h = hops.channel.shape
    arrive = _initial_arrive(hops, channels, issue_ps)
    start = depart = torch.zeros((n, h), dtype=torch.int64,
                                 device=arrive.device)
    rounds, resid = 0, -1
    while rounds < budget and resid != 0:
        eff_issue = (_join_gate(hops, issue_ps, arrive, join_seed)
                     if has_join else issue_ps)
        new_arrive, start, depart = _one_round(hops, channels, eff_issue,
                                               arrive, carry=carry)
        resid = int((new_arrive - arrive).abs().max())
        arrive = new_arrive
        rounds += 1
    return Schedule(arrive=arrive, start=start, depart=depart,
                    complete=arrive[:, h], rounds=rounds,
                    converged=resid == 0, residual_ps=max(resid, 0))


def stack_members(tables):
    """Stack per-member `Hops` (or `Channels`) along a new leading member
    axis M, field by field; an optional field is present in every member or
    in none."""
    tables = list(tables)
    out = {}
    for name in tables[0]._fields:
        vals = [getattr(t, name) for t in tables]
        if all(v is None for v in vals):
            out[name] = None
        elif any(v is None for v in vals):
            raise ValueError(f"{name} is present in some members only")
        else:
            out[name] = torch.stack(vals)
    return type(tables[0])(**out)


def member(stacked, i: int):
    """Member ``i`` of a stacked `Hops` / `Channels` / `Schedule` (or of a
    stacked tensor): the tables and per-member diagnostics one member of
    `simulate_stacked` would have had on its own."""
    if isinstance(stacked, torch.Tensor):
        return stacked[i]
    if isinstance(stacked, Schedule):
        return stacked._replace(
            arrive=stacked.arrive[i], start=stacked.start[i],
            depart=stacked.depart[i], complete=stacked.complete[i],
            rounds=stacked.rounds[i], converged=stacked.converged[i],
            residual_ps=stacked.residual_ps[i])
    return stacked._replace(**{
        name: None if val is None else val[i]
        for name, val in zip(stacked._fields, stacked)})


def _flatten_members(hops: Hops, channels: Channels, issue_ps):
    """Lay M stacked members side by side as one workload: member ``m``
    gets channel ids ``m*C .. m*C+C-1`` and row ids ``m*N .. m*N+N-1``.
    Members are contiguous in flat item order and share no channel, so one
    sort by (channel, arrival, flat index) orders each member's items
    exactly as a run of that member alone would."""
    m, n, h = hops.channel.shape
    c = channels.bw_MBps.shape[1]
    dev = hops.channel.device
    ids = torch.arange(m, device=dev, dtype=torch.int32)

    def offset(tab, stride, shape):
        off = (ids * stride).view(shape)
        return torch.where(tab >= 0, tab + off, tab).reshape(
            (m * n,) + tuple(tab.shape[2:]))

    flat = {}
    for name, val in zip(Hops._fields, hops):
        if val is None:
            flat[name] = None
        elif name == "channel":
            flat[name] = offset(val, c, (m, 1, 1))
        elif name in ("join_id", "join_wait"):
            flat[name] = offset(val, n, (m, 1))
        else:
            flat[name] = val.reshape((m * n,) + tuple(val.shape[2:]))
    ch = Channels(*(None if v is None else v.reshape(m * c)
                    for v in channels))
    return Hops(**flat), ch, issue_ps.reshape(m * n)


def simulate_stacked(hops: Hops, channels: Channels, issue_ps: torch.Tensor,
                     options: SimOptions | None = None) -> Schedule:
    """Resolve M independent workloads in one fixpoint — the counterpart of
    the reference's ``jax.vmap(simulate)`` over stacked tables.

    Every field carries a leading member axis: `Hops` tables (M, N, H) (join
    tables (M, N)), `Channels` tables (M, C), ``issue_ps`` (M, N); build
    them with `stack_members`.  Each round is one sort, one serve-scan
    launch and one scatter over all members (`_flatten_members`).  The
    budget is `round_bound` over the members (the chain term without joins,
    the maximum over members with them).  Each member stops at its own
    first zero residual, as a member of the vmapped ``lax.while_loop`` does:
    once converged, its arrivals are a fixed point, so the rounds the
    others still need leave its schedule unchanged.

    Returns a `Schedule` whose tensors carry the leading M axis and whose
    ``rounds`` / ``converged`` / ``residual_ps`` are per-member tuples;
    `member` slices out one member's schedule.
    """
    opts = options if options is not None else SimOptions()
    m, n, h = hops.channel.shape
    fh, fc, fi = _flatten_members(hops, channels, issue_ps)
    budget = opts.max_rounds if opts.max_rounds > 0 else round_bound(hops)
    has_join = fh.join_id is not None

    arrive = _initial_arrive(fh, fc, fi)
    start = depart = torch.zeros((m * n, h), dtype=torch.int64,
                                 device=arrive.device)
    rounds, resid = [0] * m, [-1] * m
    it = 0
    while it < budget and any(r != 0 for r in resid):
        eff_issue = _join_gate(fh, fi, arrive) if has_join else fi
        new_arrive, start, depart = _one_round(fh, fc, eff_issue, arrive)
        # one readback per round: every member's max |delta arrive|
        delta = (new_arrive - arrive).abs().view(m, -1).amax(dim=1).tolist()
        for i, d in enumerate(delta):
            if resid[i] != 0:
                rounds[i] += 1
                resid[i] = d
        arrive = new_arrive
        it += 1
    arrive = arrive.view(m, n, h + 1)
    return Schedule(arrive=arrive, start=start.view(m, n, h),
                    depart=depart.view(m, n, h), complete=arrive[..., h],
                    rounds=tuple(rounds),
                    converged=tuple(r == 0 for r in resid),
                    residual_ps=tuple(max(r, 0) for r in resid))


def replay_round(hops: Hops, channels: Channels, sched: Schedule,
                 carry: StreamCarry | None = None):
    """Re-run one FCFS round from a resolved schedule (telemetry replay).

    The exact schedule is a fixed point of the round map, so one pass from
    ``sched.arrive`` reproduces ``start``/``depart`` bit-for-bit and extracts
    the per-hop retraining-stall share of each grant delay.  Returns
    ``(start, depart, retrain_stall)``, each ``(N, H)``."""
    _, start, depart, stall = _one_round(
        hops, channels, sched.arrive[:, 0], sched.arrive, with_stalls=True,
        carry=carry)
    return start, depart, stall


def simulate_auto(hops: Hops, channels: Channels, issue_ps: torch.Tensor,
                  options: SimOptions | None = None, *,
                  carry: StreamCarry | None = None) -> tuple[Schedule, bool]:
    """Exact schedule with oracle fallback.  Returns (schedule, used_oracle).

    ``SimOptions.check``: "oracle" (default) falls back to the event-driven
    `ref_des` oracle when the fixpoint does not converge within its budget;
    "off" returns the fixpoint's schedule as it is; "static" first runs the
    fabric-IR verifier over the lowered triple (and the carry) and raises
    `verify.VerifyError` on any finding — an explicit ``max_rounds`` below
    the computed bound is one (``join.depth``) — then falls back as
    "oracle" does.
    """
    opts = options if options is not None else SimOptions()
    if opts.check == "static":
        from . import verify  # host-side checker

        verify.assert_valid(hops, channels, issue_ps, carry=carry,
                            max_rounds=opts.max_rounds or None)
    sched = simulate(hops, channels, issue_ps, opts, carry=carry)
    if opts.check == "off" or sched.converged:
        return sched, False
    from . import ref_des  # local import: the oracle is pure Python

    ref = ref_des.simulate_ref(hops, channels, issue_ps, carry=carry)
    return ref_des.ref_schedule(ref, hops.channel.device,
                                rounds=sched.rounds), True


# ---------------------------------------------------------------------------
# Post-schedule metrics (paper Figs. 10–12, 16, 17)
# ---------------------------------------------------------------------------

def _channel_sum(flat_c, values, c):
    out = torch.zeros(c + 1, dtype=torch.int64, device=values.device)
    return out.index_add_(0, flat_c, values.reshape(-1))[:c]


def channel_stats(hops: Hops, sched: Schedule, channels: Channels,
                  window: tuple | None = None) -> dict:
    """Per-channel busy time, payload time and queue waits.

    bus utility (Fig. 17)        = busy / window, averaged over directions
    transmission efficiency      = payload transmit time / busy time

    The two quotients are float64, as the JAX reference's int64 true
    division gives under x64.
    """
    c = channels.bw_MBps.shape[0]
    busy_item = torch.where(hops.valid, sched.depart - sched.start, 0)
    wait_item = torch.where(hops.valid, sched.start - sched.arrive[:, :-1], 0)
    ser_item = ser_ps(hops.nbytes,
                      channels.bw_MBps[hops.channel.long().clamp(0, c - 1)])
    pay_item = torch.where(hops.valid & hops.is_payload, ser_item, 0)
    flat_c = torch.where(hops.valid, hops.channel.long(), c).reshape(-1)
    busy = _channel_sum(flat_c, busy_item, c)
    payload = _channel_sum(flat_c, pay_item, c)
    wait = _channel_sum(flat_c, wait_item, c)
    if window is None:
        t0 = sched.arrive[:, 0].min()
        t1 = sched.complete.max()
    else:
        t0, t1 = (torch.as_tensor(t, device=busy.device) for t in window)
    span = torch.clamp_min(t1 - t0, 1)
    return {
        "busy_ps": busy,
        "payload_ps": payload,
        "wait_ps": wait,
        "utility": busy.double() / span.double(),
        "efficiency": payload.double() / torch.clamp_min(busy, 1).double(),
        "window_ps": span,
    }


def request_stats(hops: Hops, sched: Schedule, issue_ps: torch.Tensor,
                  payload_bytes: torch.Tensor, measured: torch.Tensor) -> dict:
    """Per-request latency/wait and steady-state aggregate bandwidth.

    ``bandwidth_MBps`` multiplies the measured payload by ``PS_PER_S`` in
    int64 exactly as the reference does, so both wrap above ~9.2 MB of
    measured payload (a reference limit, ROADMAP Queue 3)."""
    latency = sched.complete - issue_ps
    wait = torch.where(hops.valid, sched.start - sched.arrive[:, :-1],
                       0).sum(dim=1)
    n_hops = hops.valid.sum(dim=1)
    t0 = torch.where(measured, issue_ps, 1 << 60).min()
    t1 = torch.where(measured, sched.complete, 0).max()
    span_ps = torch.clamp_min(t1 - t0, 1)
    total_payload = torch.where(measured, payload_bytes, 0).sum()
    bw_MBps = total_payload * PS_PER_S // (span_ps * 1_000_000)

    # steady-state bandwidth: completion rate inside the 30%..90% completion
    # quantile window (robust to warm-up ramp and drain tail)
    comp_sorted = torch.sort(sched.complete).values
    n = comp_sorted.shape[0]
    lo, hi = (3 * n) // 10, (9 * n) // 10
    win = torch.clamp_min(comp_sorted[hi] - comp_sorted[lo], 1)
    mean_pay = payload_bytes.sum() // max(n, 1)
    steady_bw_MBps = (hi - lo) * mean_pay * PS_PER_S // (win * 1_000_000)
    return {
        "latency_ps": latency,
        "queue_wait_ps": wait,
        "n_hops": n_hops,
        "span_ps": span_ps,
        "bandwidth_MBps": bw_MBps,
        "steady_bandwidth_MBps": steady_bw_MBps,
        "mean_latency_ps": torch.where(measured, latency, 0).sum()
        // torch.clamp_min(measured.sum(), 1),
    }


def stacked_request_stats(hops: Hops, sched: Schedule, issue_ps, payload_bytes,
                          measured) -> list[dict]:
    """`request_stats` of each member of a `simulate_stacked` result (every
    argument carries the leading member axis)."""
    return [request_stats(member(hops, i), member(sched, i), issue_ps[i],
                          payload_bytes[i], measured[i])
            for i in range(len(sched.rounds))]


def stacked_channel_stats(hops: Hops, sched: Schedule, channels: Channels,
                          window: tuple | None = None) -> list[dict]:
    """`channel_stats` of each member of a `simulate_stacked` result."""
    return [channel_stats(member(hops, i), member(sched, i),
                          member(channels, i), window)
            for i in range(len(sched.rounds))]


def make_channels(graph, row_hit_ps: int = 0, row_miss_ps: int = 0,
                  device="cuda") -> Channels:
    """Lift a FabricGraph's channel tables into engine form on ``device``.

    Graphs whose links carry a flit config contribute the per-channel
    flit-mode tables; a graph with no flit links lowers to the seed's
    4-field layout."""
    dev = resolve_device(device)
    rh = np.where(graph.chan_is_service, row_hit_ps, 0).astype(np.int64)
    rm = np.where(graph.chan_is_service, row_miss_ps, 0).astype(np.int64)
    base = Channels(
        bw_MBps=to_device(graph.chan_bw_MBps, dev),
        turnaround_ps=to_device(graph.chan_turnaround_ps, dev),
        row_hit_ps=to_device(rh, dev),
        row_miss_ps=to_device(rm, dev),
    )
    fsize = getattr(graph, "chan_flit_size", None)
    if fsize is None or not np.any(np.asarray(fsize) > 0):
        return base
    return base._replace(
        flit_size=to_device(fsize, dev),
        flit_payload=to_device(graph.chan_flit_payload, dev),
        replay_ppm=to_device(graph.chan_replay_ppm, dev),
    )
