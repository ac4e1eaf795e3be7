"""Streaming windowed simulation: million-request traces at flat memory,
PyTorch port.

The counterpart of ``repro.core.streaming``, with the same names in the
same order.  `engine.simulate` resolves one bounded workload in a single
fixpoint over all rows — O(N·H) schedule tensors, a wall for
production-shaped traces.  This module turns the same engine into a
**stream processor**: a long trace is consumed as an iterator of chunks,
each chunk is resolved as one fixed-size *window* seeded with the carried
fabric state, and the resolved schedule is folded into running accumulators
(`telemetry.StreamTelemetry`) instead of being materialized.  Memory is
bounded by the window size, never the trace.

Correctness rests on one property of the FCFS engine: service order on a
channel equals the global key order ``(arrival, flat item index)``.  Let
``T_next`` be the minimum issue time of every not-yet-consumed row.  Then any
item whose **arrival is <= T_next** is *settled*: every item that could still
appear has arrival >= its issue >= ``T_next`` and loses the flat-index
tie-break (later rows get larger global ids), so nothing can ever precede the
settled item on its channel — its grant is final.  Per channel the settled
items form a key-order prefix, so the whole service history collapses to the
state after the last settled item — exactly `engine.StreamCarry`:

  * per-channel ``(depart, direction, DRAM row)`` frontier of the last
    settled serving item,
  * per-channel ``down_until`` — the running max of settled retraining
    contributions (served hops *and* link-down markers; a settled marker can
    never out-key an unsettled item, so it folds entirely into the carry),
  * per-join-group max completion of already-retired contributors.

Rows with unsettled items re-enter the next window as *suffixes*: hops before
the first unsettled valid hop ``k0`` are final, so the row restarts with
``issue = arrive[k0]``.  A fork/join waiter whose gated arrival exceeds
``T_next`` is carried whole (``k0 = 0``) with its nominal issue and its
``join_wait`` intact — its gate is re-resolved next window from the carried
group seed plus any still-in-flight contributors.  (A gated arrival <=
``T_next`` is self-consistently final: the gate bounds every contributor
completion, which bounds every contributor arrival, so all contributors are
settled and the max is exact.)

Window assembly preserves bit-exactness by construction: rows are laid out as
``[carried rows in original global order] + [chunk rows] + [padding]``, which
preserves the lexicographic (row, hop) order of flat indices and therefore
every FCFS tie-break; the `ref_des` oracle accepts the same carry, so the
windowed run — any window size — equals the monolithic run bit for bit.

Where the work runs: settlement, window assembly, the frontier update and
the backlog fold are host NumPy, as in the reference; the window's fixpoint
(`engine.simulate`: the fused serve-round kernel on the card), the
retraining replay (`engine.replay_round`) and the telemetry fold run on the
channels' device.  A chunk may be given as tensors on any device or as NumPy
arrays; each of its fields is pulled to the host once, and a window's
``arrive`` / ``start`` / ``depart`` once.  Everything sent to the device is
a copy (``torch.tensor``), never a view of a host buffer that the next
window's frontier update writes in place.

Contracts on the chunk stream (asserted here):
  * chunk minimum issue times are non-decreasing along the stream (chunks
    are windows of a time-ordered trace);
  * every fork/join group is wholly contained in one chunk, with chunk-local
    group ids (`stream_windows` cuts on group boundaries automatically);
  * all chunks share one optional-field layout (reliability / join tables).

Not ported from the reference, by design (as in `engine`): the deprecated
per-call kwargs ``max_rounds`` / ``oracle_fallback`` / ``static_check`` —
pass ``options=SimOptions(...)`` — and ``SimOptions.use_kernel``: the
tensors' device picks the serve path.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from . import ref_des, verify
from .engine import (Channels, Hops, SimOptions, StreamCarry, replay_round,
                     round_bound, simulate, to_host)
from .telemetry import (StreamTelemetry, stream_telemetry_finalize,
                        stream_telemetry_fold, stream_telemetry_new)

_INT64_MAX = np.iinfo(np.int64).max

_BASE_FIELDS = ("channel", "nbytes", "direction", "row", "fixed_after_ps",
                "is_payload", "valid")
_COLLECT_KEYS = ("item_row", "item_hop", "item_start", "item_depart",
                 "item_arrive", "row_id", "row_complete", "gate_row",
                 "gate_arrive0")
# host seconds a `StreamState` keeps per step of a window
STEPS = ("source", "verify", "assemble", "simulate", "settle")


def _np(x):
    return None if x is None else to_host(x)


def _dev(a, dev) -> torch.Tensor:
    """A device copy of a host array (``torch.tensor`` always copies)."""
    return torch.tensor(a, device=dev)


def _fold_backlog(run, peak, t, c, y):
    """Fold flushed ±1 backlog events into per-channel (run, peak) in place.

    Events are sorted (time, arrivals-first) per channel — the monolithic
    `telemetry.channel_telemetry` order.  The peak is invariant under
    reordering *within* one (channel, time, type) group (equal deltas
    commute), so any stable per-channel fold of the settled history equals
    the global sort bit-for-bit.
    """
    for cv in np.unique(c):
        m = c == cv
        o = np.lexsort((y[m], t[m]))
        bl = run[cv] + np.cumsum(np.where(y[m][o] == 0, 1, -1))
        peak[cv] = max(int(peak[cv]), int(bl.max()))
        run[cv] = int(bl[-1])


def _stall_replay(hops: Hops, channels: Channels, sched, carry: StreamCarry):
    """Per-item retraining stall of one window, replayed from its seeded
    fixpoint (`engine.replay_round` with the window's carry)."""
    return replay_round(hops, channels, sched, carry=carry)[2]


class StreamState:
    """Host-side state carried across windows: the per-channel frontier
    (mirroring `engine.StreamCarry`), the in-flight row suffixes, retired
    join-group maxes, and the running telemetry fold (on the channels'
    device).  Construct with `StreamState(channels)`; `simulate_stream`
    mutates it in place.

    ``seconds`` holds the host seconds spent in each of `STEPS` over all
    windows: ``source`` (the chunk iterator's own work and the pull of each
    chunk to the host), ``verify`` (the chunk verifier), ``assemble``
    (window layout and carry, copied to the device), ``simulate`` (the
    window's fixpoint, or the oracle, and the pull of its schedule), and
    ``settle`` (settlement, retraining replay, telemetry fold, frontier,
    backlog and suffixes).  ``sync`` is called at each step's edges
    (``torch.cuda.synchronize`` makes a step's time cover its device work;
    the default does nothing)."""

    def __init__(self, channels: Channels):
        c = int(channels.bw_MBps.shape[0])
        self.n_channels = c
        self.ch_dep = np.zeros(c, np.int64)
        self.ch_dir = np.full(c, -1, np.int8)
        self.ch_row = np.full(c, -2, np.int32)
        self.ch_down = np.zeros(c, np.int64)
        self.carried: list[dict] = []   # gid-ordered in-flight row suffixes
        self.jseed: dict = {}           # group key -> retired-contributor max
        self.telemetry: StreamTelemetry = stream_telemetry_new(
            c, channels.bw_MBps.device)
        self.layout = None              # (has_extra, has_retrain, has_join)
        self.windows = 0
        self.oracle_windows = 0
        self.n_rows = 0
        self.carried_peak = 0
        self.chunk_idx = 0
        self.gid_next = 0
        # fixpoint diagnostics folded across windows
        self.rounds_sum = 0
        self.rounds_max = 0
        self.windows_converged = 0
        # streamed peak backlog: pending ±1 events (arrive +1 / grant −1)
        # not yet flushable — events at or after T_next must wait, because
        # later windows can still emit events at exactly T_next — plus the
        # carried per-channel running backlog and peak over flushed history
        self.bl_t = np.zeros(0, np.int64)   # pending event times
        self.bl_c = np.zeros(0, np.int64)   # pending event channels
        self.bl_y = np.zeros(0, np.int8)    # pending type: 0 arrive, 1 grant
        self.bl_run = np.zeros(c, np.int64)
        self.bl_peak = np.zeros(c, np.int64)
        self.seconds = dict.fromkeys(STEPS, 0.0)
        self.sync = lambda: None
        self._t = 0.0

    def _step(self, name: str = None):
        """Close the running step (charged to ``name``) and open the next."""
        self.sync()
        now = time.perf_counter()
        if name is not None:
            self.seconds[name] += now - self._t
        self._t = now


class StreamResult(NamedTuple):
    """What a finished stream run hands back: the telemetry fold plus the
    overhead counters the study records (`windows`, `carried_peak` — peak
    in-flight rows at any window edge — and how many windows needed the
    oracle fallback).  ``collected`` (only under ``collect_schedule=True``,
    test scale) holds the settled per-item schedule in global coordinates
    for bit-exact comparison against a monolithic run.

    ``rounds`` / ``converged`` / ``residual_ps`` are the unified fixpoint
    diagnostics every entry point reports (`engine.Schedule`,
    `coherence_traffic.CoupledResult`): total engine rounds across all
    windows, whether every window's fixpoint converged on its own (a
    ``False`` here means the oracle fallback resolved some windows), and
    the residual of the *returned* schedule — always 0 for a stream, since
    a non-converged window is either oracle-resolved exactly or raises."""

    telemetry: StreamTelemetry
    windows: int
    carried_peak: int
    oracle_windows: int
    n_rows: int
    state: StreamState
    collected: dict | None = None
    rounds: int = 0
    converged: bool = True
    residual_ps: int = 0

    def summary(self, qs=(0.5, 0.99, 0.999)) -> dict:
        out = stream_telemetry_finalize(self.telemetry, qs)
        out.update(windows=self.windows, carried_peak=self.carried_peak,
                   oracle_windows=self.oracle_windows, n_rows=self.n_rows,
                   rounds_sum=self.state.rounds_sum,
                   rounds_max=self.state.rounds_max,
                   windows_converged=self.state.windows_converged)
        # drain any pending backlog events into copies: exact for a finished
        # stream (the final window flushes everything), best-effort mid-run
        run, peak = self.state.bl_run.copy(), self.state.bl_peak.copy()
        _fold_backlog(run, peak, self.state.bl_t, self.state.bl_c,
                      self.state.bl_y)
        out["peak_backlog"] = peak
        return out


def _host_chunk(chunk) -> tuple[Hops, np.ndarray]:
    """A ``(Hops, issue_ps)`` chunk with every field pulled to host NumPy
    once (tensors on any device, or arrays)."""
    hops, issue = chunk
    return Hops(*(_np(v) for v in hops)), _np(issue).astype(np.int64,
                                                            copy=False)


def _min_issue(issue) -> int:
    return int(np.min(issue))


def _ensure_layout(state: StreamState, ck_hops: Hops) -> tuple:
    layout = (ck_hops.extra_wire_bytes is not None,
              ck_hops.retrain_after_ps is not None,
              ck_hops.join_id is not None)
    if state.layout is None:
        state.layout = layout
    elif state.layout != layout:
        raise ValueError("all chunks must share one optional-field layout; "
                         f"got {layout} after {state.layout}")
    return layout


def _carry(state: StreamState, seed, dev) -> StreamCarry:
    """The window's `StreamCarry` on ``dev``: copies of the frontier, which
    `_process_window` updates in place while the device may still read the
    carry (the retraining replay and the telemetry fold are asynchronous
    on the card)."""
    return StreamCarry(
        depart_ps=_dev(state.ch_dep, dev),
        last_dir=_dev(state.ch_dir, dev),
        last_row=_dev(state.ch_row, dev),
        down_until_ps=_dev(state.ch_down, dev),
        join_seed_ps=None if seed is None else _dev(seed, dev),
    )


def _process_window(state: StreamState, channels: Channels, ck_hops: Hops,
                    ck_issue, t_next: int, opts: SimOptions, pad_to: int,
                    oracle_fallback: bool, collect: dict | None) -> None:
    """Resolve one chunk (host `Hops` and issue, `_host_chunk`) as a window
    seeded from ``state``, and fold what settles by ``t_next``."""
    has_extra, has_retrain, has_join = _ensure_layout(state, ck_hops)
    dev = channels.bw_MBps.device

    c_np = {f: getattr(ck_hops, f) for f in _BASE_FIELDS}
    if has_extra:
        c_np["extra_wire_bytes"] = ck_hops.extra_wire_bytes
    if has_retrain:
        c_np["retrain_after_ps"] = ck_hops.retrain_after_ps
    n_c, h_c = c_np["channel"].shape
    c_issue = ck_issue
    ci = state.chunk_idx
    carried = state.carried
    n_k = len(carried)
    n_raw = n_k + n_c

    # ---- window group-id space: carried groups first, then chunk groups
    keys: dict = {}
    if has_join:
        for r in carried:
            for key in (r["jwait"], r["jid"]):
                if key is not None:
                    keys.setdefault(key, len(keys))
        cj = ck_hops.join_id
        cw = ck_hops.join_wait
        for g in np.unique(np.concatenate([cj[cj >= 0], cw[cw >= 0]])):
            keys.setdefault((ci, int(g)), len(keys))
    n_groups = len(keys)

    n_pad = -(-max(n_raw, n_groups, 1) // pad_to) * pad_to
    h_w = max([h_c, 1] + [r["hops"]["channel"].shape[0] for r in carried])

    # ---- assemble the window: carried suffixes, chunk rows, padding
    W = {
        "channel": np.zeros((n_pad, h_w), np.int32),
        "nbytes": np.zeros((n_pad, h_w), np.int64),
        "direction": np.zeros((n_pad, h_w), np.int8),
        "row": np.full((n_pad, h_w), -1, np.int32),
        "fixed_after_ps": np.zeros((n_pad, h_w), np.int64),
        "is_payload": np.zeros((n_pad, h_w), bool),
        "valid": np.zeros((n_pad, h_w), bool),
    }
    if has_extra:
        W["extra_wire_bytes"] = np.zeros((n_pad, h_w), np.int64)
    if has_retrain:
        W["retrain_after_ps"] = np.zeros((n_pad, h_w), np.int64)
    issue_w = np.zeros(n_pad, np.int64)
    orig_issue = np.zeros(n_pad, np.int64)
    gid_w = np.full(n_pad, -1, np.int64)
    hop0_w = np.zeros(n_pad, np.int64)
    if has_join:
        jid_w = np.full(n_pad, -1, np.int32)
        jwait_w = np.full(n_pad, -1, np.int32)

    for i, r in enumerate(carried):
        length = r["hops"]["channel"].shape[0]
        for f, a in r["hops"].items():
            W[f][i, :length] = a
        issue_w[i] = r["issue"]
        orig_issue[i] = r["orig_issue"]
        gid_w[i] = r["gid"]
        hop0_w[i] = r["hop0"]
        if has_join:
            if r["jid"] is not None:
                jid_w[i] = keys[r["jid"]]
            if r["jwait"] is not None:
                jwait_w[i] = keys[r["jwait"]]
    for f in W:
        W[f][n_k:n_raw, :h_c] = c_np[f]
    issue_w[n_k:n_raw] = c_issue
    orig_issue[n_k:n_raw] = c_issue
    gid_w[n_k:n_raw] = state.gid_next + np.arange(n_c)
    state.gid_next += n_c
    seed = None
    if has_join:
        for src, dst in ((cj, jid_w), (cw, jwait_w)):
            m = src >= 0
            dst[n_k:n_raw][m] = np.fromiter(
                (keys[(ci, int(g))] for g in src[m]), np.int32, int(m.sum()))
        # arity contract rewritten to the contributors actually present in
        # this window; retired contributors act through the group seed
        counts = np.bincount(jid_w[jid_w >= 0], minlength=max(n_groups, 1))
        jar_w = np.zeros(n_pad, np.int32)
        wm = jwait_w >= 0
        jar_w[wm] = counts[jwait_w[wm]].astype(np.int32)
        seed = np.zeros(n_pad, np.int64)
        for key, v in state.jseed.items():
            seed[keys[key]] = v

    hops_w = Hops(
        **{f: _dev(a, dev) for f, a in W.items()},
        join_id=_dev(jid_w, dev) if has_join else None,
        join_wait=_dev(jwait_w, dev) if has_join else None,
        join_arity=_dev(jar_w, dev) if has_join else None,
    )
    carry = _carry(state, seed, dev)
    state._step("assemble")

    # ---- resolve the window from the carried frontier
    sched = simulate(hops_w, channels, _dev(issue_w, dev), opts, carry=carry)
    if sched.converged:
        arr = to_host(sched.arrive)
        st = to_host(sched.start)
        dp = to_host(sched.depart)
        fold_sched = sched
    else:
        if not oracle_fallback:
            raise RuntimeError(
                f"window {state.windows} did not converge in "
                f"{opts.max_rounds or round_bound(hops_w)} rounds "
                "(check='off' disables the oracle fallback)")
        # the oracle reads the host copies the window was assembled from
        hops_h = Hops(**W, join_id=jid_w if has_join else None,
                      join_wait=jwait_w if has_join else None,
                      join_arity=jar_w if has_join else None)
        carry_h = StreamCarry(state.ch_dep, state.ch_dir, state.ch_row,
                              state.ch_down, seed)
        ref = ref_des.simulate_ref(hops_h, channels, issue_w, carry=carry_h)
        arr, st, dp = ref["arrive"], ref["start"], ref["depart"]
        fold_sched = ref_des.ref_schedule(ref, dev, rounds=sched.rounds)
        state.oracle_windows += 1
    r_used = sched.rounds
    state.rounds_sum += r_used
    state.rounds_max = max(state.rounds_max, r_used)
    state.windows_converged += int(sched.converged)
    state._step("simulate")

    # ---- settlement: arrival <= T_next is final (see module docstring)
    valid_np = W["valid"]
    arr_h = arr[:, :h_w]
    settled = arr_h <= t_next
    real = gid_w >= 0
    uns = valid_np & ~settled
    anyu = uns.any(axis=1)
    k0 = np.where(anyu, uns.argmax(axis=1), h_w)
    if has_join:
        hold = (jwait_w >= 0) & (arr[:, 0] > t_next) & real
        k0 = np.where(hold, 0, k0)
    else:
        hold = np.zeros(n_pad, bool)
    carried_mask = real & (anyu | hold)
    retired = real & ~carried_mask

    # ---- fold settled items / retired rows into the running telemetry
    # gated arrival (hence the row's join wait) is final once the row
    # retires or makes progress — each global row is recorded exactly once
    gate_rec = (real & (hop0_w == 0)
                & (retired | (carried_mask & (k0 > 0))))
    lat = np.where(retired, arr[:, h_w] - orig_issue, 0)
    gate_wait = np.where(gate_rec, arr[:, 0] - orig_issue, 0)
    if has_retrain:
        stall = _stall_replay(hops_w, channels, fold_sched, carry)
    else:
        stall = torch.zeros((n_pad, h_w), dtype=torch.int64, device=dev)
    state.telemetry = stream_telemetry_fold(
        state.telemetry, hops_w, channels, fold_sched,
        _dev(valid_np & settled, dev), _dev(retired, dev), _dev(lat, dev),
        stall, _dev(gate_rec, dev), _dev(gate_wait, dev))

    if collect is not None:
        si, sh = np.nonzero((valid_np & settled) & real[:, None])
        collect["item_row"].append(gid_w[si])
        collect["item_hop"].append(hop0_w[si] + sh)
        collect["item_start"].append(st[si, sh])
        collect["item_depart"].append(dp[si, sh])
        collect["item_arrive"].append(arr[si, sh])
        rr = np.nonzero(retired)[0]
        collect["row_id"].append(gid_w[rr])
        collect["row_complete"].append(arr[rr, h_w])
        rec = np.nonzero(gate_rec)[0]
        collect["gate_row"].append(gid_w[rec])
        collect["gate_arrive0"].append(arr[rec, 0])

    # ---- advance the per-channel frontier past this window's settled prefix
    serving = valid_np & (W["nbytes"] > 0)
    ssi = serving & settled
    ri, hi = np.nonzero(ssi)
    if ri.size:
        chs = W["channel"][ri, hi].astype(np.int64)
        ars = arr_h[ri, hi]
        fls = ri * h_w + hi
        order = np.lexsort((fls, ars, chs))
        sc = chs[order]
        lastm = np.append(sc[1:] != sc[:-1], True)
        sel = order[lastm]
        lc = sc[lastm]
        state.ch_dep[lc] = dp[ri[sel], hi[sel]]
        state.ch_dir[lc] = W["direction"][ri[sel], hi[sel]]
        rows = W["row"][ri, hi]
        rm = rows >= 0
        if rm.any():
            order2 = np.lexsort((fls[rm], ars[rm], chs[rm]))
            sc2 = chs[rm][order2]
            lastm2 = np.append(sc2[1:] != sc2[:-1], True)
            state.ch_row[sc2[lastm2]] = rows[rm][order2[lastm2]]
    if has_retrain:
        ret = W["retrain_after_ps"]
        m1 = ssi & (ret > 0)
        if m1.any():
            np.maximum.at(state.ch_down, W["channel"][m1], dp[m1] + ret[m1])
        mk = valid_np & (W["nbytes"] == 0) & (ret > 0) & settled
        if mk.any():
            np.maximum.at(state.ch_down, W["channel"][mk],
                          arr_h[mk] + ret[mk])

    # ---- streamed peak backlog: settled serving items emit +1 at arrival,
    # −1 at grant; events strictly before T_next are flushed into the
    # per-channel running fold (every future event is >= T_next: carried
    # items arrive after it, new chunks issue at or after it), events at or
    # after T_next stay pending so later same-instant arrivals keep the
    # monolithic (time, arrivals-first) order
    ev_t = np.concatenate([state.bl_t, arr_h[ri, hi], st[ri, hi]])
    bc = W["channel"][ri, hi].astype(np.int64)
    ev_c = np.concatenate([state.bl_c, bc, bc])
    ev_y = np.concatenate([state.bl_y, np.zeros(ri.size, np.int8),
                           np.ones(ri.size, np.int8)])
    fl = ev_t < t_next
    if fl.any():
        _fold_backlog(state.bl_run, state.bl_peak,
                      ev_t[fl], ev_c[fl], ev_y[fl])
    keep = ~fl
    state.bl_t, state.bl_c, state.bl_y = ev_t[keep], ev_c[keep], ev_y[keep]

    # ---- extract the rows still in flight as next-window suffixes
    inv = {v: k for k, v in keys.items()} if has_join else {}
    new_carried = []
    for p in np.nonzero(carried_mask)[0]:
        k = int(k0[p])
        vrow = valid_np[p]
        top = max((h_w - int(vrow[::-1].argmax())) if vrow.any() else 0, k)
        jw = jd = None
        if has_join:
            if hold[p]:
                jw = inv[int(jwait_w[p])]
            if jid_w[p] >= 0:
                jd = inv[int(jid_w[p])]
        new_carried.append(dict(
            hops={f: W[f][p, k:top].copy() for f in W},
            issue=int(issue_w[p]) if k == 0 else int(arr[p, k]),
            orig_issue=int(orig_issue[p]),
            gid=int(gid_w[p]),
            hop0=int(hop0_w[p]) + k,
            jwait=jw, jid=jd,
        ))

    # retired contributors of still-gated groups act through the seed;
    # groups whose every waiter retired are dead — drop their entries
    alive = {r["jwait"] for r in new_carried if r["jwait"] is not None}
    new_seed = {k: v for k, v in state.jseed.items() if k in alive}
    if has_join and alive:
        for p in np.nonzero(retired & (jid_w >= 0))[0]:
            key = inv[int(jid_w[p])]
            if key in alive:
                new_seed[key] = max(new_seed.get(key, 0), int(arr[p, h_w]))
    state.jseed = new_seed

    state.carried = new_carried
    state.carried_peak = max(state.carried_peak, len(new_carried))
    state.windows += 1
    state.n_rows += n_c
    state.chunk_idx += 1
    state._step("settle")


def simulate_stream(chunks, channels: Channels, state: StreamState = None,
                    options: SimOptions | None = None, *,
                    pad_to: int = 64,
                    collect_schedule: bool = False) -> StreamResult:
    """Drive a chunked trace through windowed simulation (module docstring).

    chunks    iterator/iterable of ``(Hops, issue_ps)``, tensors on any
              device or NumPy arrays — e.g. `stream_windows` over a
              monolithic trace, or `coherence_traffic.CoherenceStream`.  One
              chunk of lookahead is held to know ``T_next``; chunk
              min-issues must be non-decreasing (asserted).
    channels  `engine.Channels`; their device is where every window runs
              (the card unless the caller built them on the CPU).
    state     carry from a previous call (continues the fold); a fresh
              `StreamState(channels)` when None.  The final window settles
              everything, so each call drains (no rows stay in flight).
    options   `engine.SimOptions` — the uniform knob set of every entry
              point.  ``max_rounds=0`` gives each window its computed
              join-depth bound; ``check`` maps onto the stream's two
              guards: ``"static"`` (default here) runs the fabric-IR
              verifier over every incoming chunk *and* keeps the per-window
              `ref_des` oracle fallback, ``"oracle"`` (and ``"extend"``)
              keeps only the fallback, ``"off"`` disables both (a
              non-converged window then raises).  The chunk verifier
              matters because the settlement rule silently mis-settles on
              tables that break the engine contracts — chunks from
              third-party lowerings are checked at the door (host-side
              numpy; raises `verify.VerifyError`).
    pad_to    row-count bucket for window shapes (the reference's, so
              window shapes, flat indices and ``carried_peak`` match).
    collect_schedule
              accumulate every settled item's (start, depart, arrive) and
              every row's completion/gated-arrival in global coordinates —
              the equivalence-test hook; O(trace) memory, test scale only.

    Returns `StreamResult`; tail quantiles via ``result.summary()``.
    """
    if options is not None and not isinstance(options, SimOptions):
        raise TypeError(
            f"options must be a SimOptions, got {type(options).__name__}")
    check = "static" if options is None else options.check
    mr = 0 if options is None else options.max_rounds
    do_static = check == "static"
    do_oracle = check != "off"
    win_opts = SimOptions(max_rounds=mr, check="off")
    if state is None:
        state = StreamState(channels)
    collect = {k: [] for k in _COLLECT_KEYS} if collect_schedule else None
    state._step()
    it = (_host_chunk(ck) for ck in chunks)
    cur = next(it, None)
    prev_min = None
    while cur is not None:
        nxt = next(it, None)
        while nxt is not None and int(nxt[1].shape[0]) == 0:
            nxt = next(it, None)
        if int(cur[1].shape[0]) == 0:
            cur = nxt
            continue
        state._step("source")
        # layout mismatch is a caller error with a specific remedy — report
        # it as such rather than as whatever IR findings the odd chunk
        # happens to produce against the shared channel tables
        _ensure_layout(state, cur[0])
        if do_static:
            verify.assert_valid(cur[0], channels, cur[1])
        state._step("verify")
        mn = _min_issue(cur[1])
        if prev_min is not None and mn < prev_min:
            raise ValueError(
                f"chunk stream out of order: min issue {mn} after "
                f"{prev_min} — chunks must be windows of a time-ordered "
                "trace")
        prev_min = mn
        t_next = _INT64_MAX if nxt is None else _min_issue(nxt[1])
        _process_window(state, channels, cur[0], cur[1], t_next, win_opts,
                        pad_to, do_oracle, collect)
        cur = nxt
    if state.carried:
        raise AssertionError(
            f"{len(state.carried)} rows still in flight after the final "
            "window — settlement bug (the last window's T_next is +inf)")
    collected = None
    if collect is not None:
        collected = {k: (np.concatenate(v) if v else np.zeros(0, np.int64))
                     for k, v in collect.items()}
    return StreamResult(telemetry=state.telemetry, windows=state.windows,
                        carried_peak=state.carried_peak,
                        oracle_windows=state.oracle_windows,
                        n_rows=state.n_rows, state=state,
                        collected=collected, rounds=state.rounds_sum,
                        converged=state.windows_converged == state.windows,
                        residual_ps=0)


def stream_windows(hops: Hops, issue_ps, window_rows: int):
    """Slice a monolithic ``(Hops, issue_ps)`` into `simulate_stream` chunks
    of ``window_rows`` rows, on the device of the input (NumPy arrays in,
    NumPy arrays out; tensors in, slices of those tensors out).

    Fork/join groups are never split: a window boundary slides forward past
    any row range a group spans, and group ids are remapped chunk-local (the
    chunk contract).  Rows must already be in non-decreasing issue order —
    `simulate_stream` asserts the resulting chunk mins.
    """
    fields = dict(zip(Hops._fields, hops))
    issue = issue_ps
    if not isinstance(issue, torch.Tensor):
        issue = np.asarray(issue, np.int64)
    n = int(fields["channel"].shape[0])
    has_join = fields["join_id"] is not None
    blocked = np.zeros(n + 1, bool)
    if has_join:
        jid, jwait = _np(fields["join_id"]), _np(fields["join_wait"])
        lo: dict = {}
        hi: dict = {}
        for p in range(n):
            for g in (int(jid[p]), int(jwait[p])):
                if g >= 0:
                    lo[g] = min(lo.get(g, p), p)
                    hi[g] = max(hi.get(g, p), p)
        for g, a in lo.items():
            blocked[a + 1:hi[g] + 1] = True
    a = 0
    while a < n:
        b = min(a + window_rows, n)
        while b < n and blocked[b]:
            b += 1
        kw = {}
        if has_join:
            jid_s = jid[a:b].copy()
            jw_s = jwait[a:b].copy()
            present = np.unique(np.concatenate(
                [jid_s[jid_s >= 0], jw_s[jw_s >= 0]]))
            if present.size:
                lut = np.full(int(present.max()) + 1, -1, np.int32)
                lut[present] = np.arange(present.size, dtype=np.int32)
                jid_s[jid_s >= 0] = lut[jid_s[jid_s >= 0]]
                jw_s[jw_s >= 0] = lut[jw_s[jw_s >= 0]]
            kw = dict(join_id=_like(jid_s, fields["join_id"]),
                      join_wait=_like(jw_s, fields["join_wait"]),
                      join_arity=fields["join_arity"][a:b])
        for f in ("extra_wire_bytes", "retrain_after_ps"):
            if fields[f] is not None:
                kw[f] = fields[f][a:b]
        yield Hops(*(fields[f][a:b] for f in _BASE_FIELDS), **kw), issue[a:b]
        a = b


def _like(a: np.ndarray, ref):
    """``a`` as a tensor on ``ref``'s device when ``ref`` is a tensor."""
    return _dev(a, ref.device) if isinstance(ref, torch.Tensor) else a
