"""Fabric-IR verifier: static contract checking for lowered workloads.

The PyTorch port's counterpart of ``repro.core.verify``, check for check.
A lowered ``(Hops, Channels, issue_ps)`` triple, plus the optional
reliability / fork-join / streaming-carry extensions, carries contracts
that the engine otherwise enforces only at run time.  This module checks
them *without running the engine* and returns a `VerifyReport`, a list of
typed `Finding`s with row/hop/channel coordinates, rather than raising;
the strict entry points (`assert_valid`, ``simulate_auto(check="static")``,
``verify_built(...).raise_if_failed()`` in the link-layer studies' set-up)
raise `VerifyError` on the first dirty report.

Contract set (one code family per subsystem):

  shape.*   every (N, H) table shares one shape; issue/join tables are (N,)
  dtype.*   int32 index columns, int8 directions, bool masks, int64
            ps-domain clocks and byte counts
  chan.*    channel indices of valid hops in [0, C); channel tables
            positive/non-negative where required; flit tables come as a
            trio with sane geometry; ``chan_pair`` is symmetric
  hop.*     non-negative bytes and fixed latencies on valid hops
  join.*    join tables come as a triple; group ids row-indexed < N;
            ``join_arity`` equals the group's contributor count; the group
            graph is a DAG; an explicit ``max_rounds`` budget below the
            computed `round_bound` is flagged (``join.depth``)
  rel.*     reliability tables come as a pair and are non-negative; replay
            bytes only on serving hops; link-down markers are structurally
            valid; replay bytes never double-count with an expected-value
            ``replay_ppm`` channel; with the per-channel sampling tables the
            quantization and ``events <= failures // retrain_threshold``
            invariants hold
  issue.*   non-decreasing issue clocks when ``monotone_issue=True``
  carry.*   `StreamCarry` frontier shapes/dtypes/values
  sf.*      snoop-filter event columns (any object with the reference's
            ``SFEvents`` fields) share the request count; counters
            non-negative; a cache hit snoops only on a write conflict

Every table is read through `engine.to_host`, so tensors on the card, CPU
tensors, numpy arrays and the reference's JAX arrays all verify alike; the
dtypes checked are the numpy dtypes the port's tensors carry
(`convert._HOPS_DTYPES`).  Everything runs on the host in numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .engine import to_host


class Finding(NamedTuple):
    """One contract violation.  ``code`` is the stable, typed identifier
    (``family.check``, e.g. ``"join.cycle"``); ``row``/``hop``/``channel``
    locate the first offending coordinate (-1 = not applicable)."""

    code: str
    message: str
    row: int = -1
    hop: int = -1
    channel: int = -1

    def __str__(self) -> str:
        loc = ", ".join(f"{k}={v}" for k, v in
                        (("row", self.row), ("hop", self.hop),
                         ("channel", self.channel)) if v >= 0)
        return f"[{self.code}] {self.message}" + (f" ({loc})" if loc else "")


class VerifyError(ValueError):
    """Raised by strict verification; carries the full report."""

    def __init__(self, report: "VerifyReport"):
        self.report = report
        super().__init__(report.summary())


class VerifyReport(NamedTuple):
    findings: tuple[Finding, ...]
    n_rows: int
    n_channels: int

    @property
    def ok(self) -> bool:
        return not self.findings

    @property
    def codes(self) -> tuple[str, ...]:
        return tuple(f.code for f in self.findings)

    def summary(self) -> str:
        if self.ok:
            return (f"verify: OK ({self.n_rows} rows, "
                    f"{self.n_channels} channels)")
        head = (f"verify: {len(self.findings)} finding(s) on "
                f"{self.n_rows} rows / {self.n_channels} channels")
        return "\n".join([head] + [f"  {f}" for f in self.findings[:20]])

    def raise_if_failed(self) -> "VerifyReport":
        if not self.ok:
            raise VerifyError(self)
        return self


def _np(x):
    """Host numpy view of a table given as a tensor on any device, a numpy
    array or any array-like (the reference's JAX arrays included)."""
    return None if x is None else to_host(x)


def _first(mask) -> tuple[int, int]:
    """(row, hop) of the first True in a 1-D or 2-D mask."""
    idx = np.argwhere(mask)
    if idx.size == 0:
        return -1, -1
    if idx.shape[1] == 1:
        return int(idx[0, 0]), -1
    return int(idx[0, 0]), int(idx[0, 1])


class _Checker:
    def __init__(self):
        self.findings: list[Finding] = []

    def add(self, code, message, row=-1, hop=-1, channel=-1):
        self.findings.append(Finding(code, message, row, hop, channel))

    def expect_dtype(self, arr, want: str, name: str, code="dtype"):
        kinds = {"int64": ("i", 8), "int32": ("i", 4), "int8": ("i", 1),
                 "bool": ("b", 1)}
        kind, size = kinds[want]
        if arr.dtype.kind != kind or arr.dtype.itemsize != size:
            self.add(f"{code}.{name}",
                     f"{name} must be {want}, got {arr.dtype}")
            return False
        return True


# ---------------------------------------------------------------------------
# Per-subsystem checks
# ---------------------------------------------------------------------------

def _check_shapes_dtypes(ck: _Checker, hops, issue) -> bool:
    """Table geometry + dtype contracts.  Returns False when the geometry
    is too broken for the value checks to index safely."""
    chan = _np(hops.channel)
    if chan.ndim != 2:
        ck.add("shape.table", f"channel must be (N, H), got {chan.shape}")
        return False
    shape = chan.shape
    usable = True
    for f in ("nbytes", "direction", "row", "fixed_after_ps", "is_payload",
              "valid", "extra_wire_bytes", "retrain_after_ps"):
        a = _np(getattr(hops, f))
        if a is not None and a.shape != shape:
            ck.add("shape.table", f"{f} shape {a.shape} != channel {shape}")
            usable = False
    if issue.shape != (shape[0],):
        ck.add("shape.issue",
               f"issue_ps shape {issue.shape} != ({shape[0]},)")
        usable = False
    for f in ("join_id", "join_wait", "join_arity"):
        a = _np(getattr(hops, f))
        if a is not None and a.shape != (shape[0],):
            ck.add("shape.join", f"{f} shape {a.shape} != ({shape[0]},)")
            usable = False

    ck.expect_dtype(chan, "int32", "channel")
    ck.expect_dtype(_np(hops.nbytes), "int64", "nbytes")
    ck.expect_dtype(_np(hops.direction), "int8", "direction")
    ck.expect_dtype(_np(hops.row), "int32", "row")
    ck.expect_dtype(_np(hops.fixed_after_ps), "int64", "fixed_after_ps")
    ck.expect_dtype(_np(hops.is_payload), "bool", "is_payload")
    ck.expect_dtype(_np(hops.valid), "bool", "valid")
    ck.expect_dtype(issue, "int64", "issue_ps", code="issue")
    for f in ("extra_wire_bytes", "retrain_after_ps"):
        a = _np(getattr(hops, f))
        if a is not None:
            ck.expect_dtype(a, "int64", f)
    for f in ("join_id", "join_wait", "join_arity"):
        a = _np(getattr(hops, f))
        if a is not None:
            ck.expect_dtype(a, "int32", f)
    return usable


def _check_channels(ck: _Checker, channels):
    bw = _np(channels.bw_MBps)
    if bw.ndim != 1:
        ck.add("chan.table", f"bw_MBps must be (C,), got {bw.shape}")
        return
    for f in ("turnaround_ps", "row_hit_ps", "row_miss_ps"):
        a = _np(getattr(channels, f))
        if a.shape != bw.shape:
            ck.add("chan.table", f"{f} shape {a.shape} != bw {bw.shape}")
            return
    for f in ("bw_MBps", "turnaround_ps", "row_hit_ps", "row_miss_ps"):
        ck.expect_dtype(_np(getattr(channels, f)), "int64", f, code="chan")
    if np.any(bw < 1):
        c, _ = _first(bw < 1)
        ck.add("chan.table", "bw_MBps must be >= 1 (ser_ps divides by it)",
               channel=c)
    for f in ("turnaround_ps", "row_hit_ps", "row_miss_ps"):
        a = _np(getattr(channels, f))
        if np.any(a < 0):
            c, _ = _first(a < 0)
            ck.add("chan.table", f"{f} must be non-negative", channel=c)

    flit = [_np(getattr(channels, f))
            for f in ("flit_size", "flit_payload", "replay_ppm")]
    present = [a is not None for a in flit]
    if any(present) and not all(present):
        ck.add("chan.flit", "flit_size/flit_payload/replay_ppm come as a "
               "trio (the link-layer lowering contract)")
        return
    if not any(present):
        return
    fsize, fpay, ppm = flit
    for name, a in (("flit_size", fsize), ("flit_payload", fpay),
                    ("replay_ppm", ppm)):
        if a.shape != bw.shape:
            ck.add("chan.flit", f"{name} shape {a.shape} != bw {bw.shape}")
            return
        ck.expect_dtype(a, "int64", name, code="chan")
    on = fsize > 0
    if np.any(fsize < 0):
        ck.add("chan.flit", "flit_size must be >= 0 (0 = byte-exact)",
               channel=_first(fsize < 0)[0])
    if np.any(on & (fpay < 1)):
        ck.add("chan.flit", "flit_payload must be >= 1 on flit channels",
               channel=_first(on & (fpay < 1))[0])
    if np.any(on & (fpay > fsize)):
        ck.add("chan.flit", "flit_payload cannot exceed flit_size "
               "(payload bytes ride inside the flit)",
               channel=_first(on & (fpay > fsize))[0])
    if np.any(ppm < 0):
        ck.add("chan.flit", "replay_ppm must be non-negative",
               channel=_first(ppm < 0)[0])


def _check_hops(ck: _Checker, hops, n_channels: int):
    chan = _np(hops.channel)
    valid = _np(hops.valid)
    nbytes = _np(hops.nbytes)
    fixed = _np(hops.fixed_after_ps)
    oob = valid & ((chan < 0) | (chan >= n_channels))
    if np.any(oob):
        r, h = _first(oob)
        ck.add("chan.bounds",
               f"valid hop channel {int(chan[r, h])} outside [0, "
               f"{n_channels})", row=r, hop=h)
    if np.any(valid & (nbytes < 0)):
        r, h = _first(valid & (nbytes < 0))
        ck.add("hop.negative", "nbytes must be non-negative on valid hops",
               row=r, hop=h)
    if np.any(valid & (fixed < 0)):
        r, h = _first(valid & (fixed < 0))
        ck.add("hop.negative",
               "fixed_after_ps must be non-negative on valid hops",
               row=r, hop=h)


def _check_join(ck: _Checker, hops):
    jid = _np(hops.join_id)
    jw = _np(hops.join_wait)
    ja = _np(hops.join_arity)
    present = [a is not None for a in (jid, jw, ja)]
    if not any(present):
        return
    if not all(present):
        ck.add("join.partial",
               "join_id/join_wait/join_arity come as a triple")
        return
    n = jid.shape[0]
    for name, a in (("join_id", jid), ("join_wait", jw)):
        bad = (a < -1) | (a >= n)
        if np.any(bad):
            r, _ = _first(bad)
            ck.add("join.bounds",
                   f"{name} {int(a[r])} outside [-1, {n}): the engine "
                   "resolves group maxes with a row-indexed scatter", row=r)
            return

    n_contrib = np.bincount(jid[jid >= 0], minlength=n) if n else \
        np.zeros(0, np.int64)
    waiters = np.nonzero(jw >= 0)[0]
    bad_ar = waiters[ja[waiters] != n_contrib[jw[waiters]]]
    if bad_ar.size:
        r = int(bad_ar[0])
        g = int(jw[r])
        ck.add("join.arity",
               f"row {r}: join_arity {int(ja[r])} != {int(n_contrib[g])} "
               f"contributors of group {g} (the oracle's release count)",
               row=r)

    # group-graph acyclicity: a contributor row held by an unreleased group
    # blocks its own group's release — propagate releases to a fixpoint
    # (mirrors the oracle's event cascade) and report what never releases
    gated = np.zeros(n, bool)
    gated[waiters[n_contrib[jw[waiters]] > 0]] = True
    remaining = n_contrib.copy()
    np.subtract.at(remaining, jid[(jid >= 0) & ~gated],
                   np.ones(int(((jid >= 0) & ~gated).sum()), np.int64))
    by_wait: dict[int, list[int]] = {}
    for p in waiters[gated[waiters] & (jid[waiters] >= 0)]:
        by_wait.setdefault(int(jw[p]), []).append(int(p))
    queue = list(np.nonzero((remaining == 0) & (n_contrib > 0))[0])
    released = set(queue)
    while queue:
        g = queue.pop()
        for p in by_wait.get(int(g), ()):
            tg = int(jid[p])
            remaining[tg] -= 1
            if remaining[tg] == 0 and tg not in released:
                released.add(tg)
                queue.append(tg)
    stuck = np.nonzero((n_contrib > 0) & (remaining > 0))[0]
    if stuck.size:
        ck.add("join.cycle",
               f"join groups {[int(g) for g in stuck[:8]]} never release — "
               "the group graph is not a DAG (deadlocks the oracle, never "
               "converges in the engine)", row=int(stuck[0]))


def _check_reliability(ck: _Checker, hops, channels, chan_pair=None,
                       reliability=None):
    extra = _np(hops.extra_wire_bytes)
    retrain = _np(hops.retrain_after_ps)
    if extra is None and retrain is None:
        return
    if (extra is None) != (retrain is None):
        ck.add("rel.partial",
               "extra_wire_bytes/retrain_after_ps come as a pair "
               "(finish_hops lowering contract)")
        return
    chan = _np(hops.channel)
    valid = _np(hops.valid)
    nbytes = _np(hops.nbytes)
    n_ch = _np(channels.bw_MBps).shape[0]
    cc = np.clip(chan, 0, n_ch - 1)
    for name, a in (("extra_wire_bytes", extra), ("retrain_after_ps",
                                                  retrain)):
        if np.any(a < 0):
            r, h = _first(a < 0)
            ck.add("rel.negative", f"{name} must be non-negative",
                   row=r, hop=h)
    # NB: extra_wire_bytes on invalid or zero-byte hops is NOT an
    # engine-level error — the engine masks invalid hops entirely and
    # wire_ser_ps serializes extra bytes on valid zero-byte hops just
    # fine.  It only breaks the *sampler's* contract (sample_hop_tables
    # masks on valid & nbytes > 0), so it's checked in `_check_sampling`,
    # which runs when the per-channel sampling tables are supplied
    # (verify_built / an explicit ``reliability=``).
    ppm = _np(channels.replay_ppm)
    if ppm is not None and np.any((extra > 0) & (ppm[cc] > 0) & valid):
        r, h = _first((extra > 0) & (ppm[cc] > 0) & valid)
        ck.add("rel.double-count",
               "sampled replay bytes on a channel with expected-value "
               "replay_ppm > 0 — the two reliability models are mutually "
               "exclusive per channel", row=r, hop=h,
               channel=int(chan[r, h]))

    marker = valid & (nbytes == 0) & (retrain > 0)
    if np.any(marker):
        turn = _np(channels.turnaround_ps)
        row_t = _np(hops.row)
        bad = marker & (turn[cc] != 0)
        if np.any(bad):
            r, h = _first(bad)
            ck.add("rel.marker",
                   "link-down marker on a channel with turnaround != 0 — "
                   "markers are full-duplex-pair mirrors only", row=r, hop=h,
                   channel=int(chan[r, h]))
        bad = marker & (row_t >= 0)
        if np.any(bad):
            r, h = _first(bad)
            ck.add("rel.marker", "link-down marker on a row-managed hop",
                   row=r, hop=h)
        if chan_pair is not None:
            pair = np.asarray(chan_pair)
            for r, h in np.argwhere(marker):
                trig_c = int(chan[r, h - 1]) if h > 0 else -1
                if (h == 0 or not valid[r, h - 1] or nbytes[r, h - 1] <= 0
                        or retrain[r, h - 1] != retrain[r, h]
                        or trig_c < 0 or pair[trig_c] != chan[r, h]):
                    ck.add("rel.marker-pair",
                           "link-down marker not paired with an immediately "
                           "preceding triggering hop on its chan_pair "
                           "partner", row=int(r), hop=int(h),
                           channel=int(chan[r, h]))
                    break

    if reliability is not None:
        _check_sampling(ck, chan, valid, nbytes, extra, retrain, marker
                        if np.any(marker) else np.zeros_like(valid),
                        reliability)


def _check_sampling(ck: _Checker, chan, valid, nbytes, extra, retrain,
                    marker, rel: dict):
    """Quantization + coupled-draw invariants of `link_layer.sample_replays`
    against the per-channel sampling tables (`devices._reliability_tables`
    / `link_layer.broadcast_reliability_tables` layout)."""
    stoch = np.asarray(rel["stochastic"], bool)
    fsize = np.asarray(rel["flit_size"])
    rwin = np.asarray(rel["retry_window"])
    rthr = np.asarray(rel["retrain_threshold"])
    rps = np.asarray(rel["retrain_ps"])
    serving = valid & (nbytes > 0)
    # sample_hop_tables only writes extra bytes where valid & nbytes > 0 —
    # a sample anywhere else means the tables didn't come from the sampler
    if np.any((extra > 0) & ~serving):
        r, h = _first((extra > 0) & ~serving)
        ck.add("rel.extra-on-empty",
               "extra_wire_bytes on a non-serving hop (the sampler only "
               "draws replays for valid hops with payload bytes)",
               row=r, hop=h)
    for c in np.nonzero(stoch)[0]:
        m = serving & (chan == c)
        if not m.any():
            continue
        quantum = max(int(fsize[c]), 1) * max(int(rwin[c]), 1)
        if np.any(extra[m] % quantum != 0):
            r, h = _first(m & (extra % quantum != 0))
            ck.add("rel.replay-quantum",
                   f"extra_wire_bytes not a multiple of the replay quantum "
                   f"{quantum} (flit_size x retry_window) on channel "
                   f"{int(c)}", row=r, hop=h, channel=int(c))
            continue
        ev_m = m | (marker & (chan == c))
        if int(rps[c]) <= 0 or int(rthr[c]) <= 0:
            if np.any(retrain[ev_m] > 0):
                r, h = _first(ev_m & (retrain > 0))
                ck.add("rel.events",
                       f"retrain_after_ps > 0 on channel {int(c)} whose "
                       "sampling tables disable retraining", row=r, hop=h,
                       channel=int(c))
            continue
        if np.any(retrain[ev_m] % int(rps[c]) != 0):
            r, h = _first(ev_m & (retrain % int(rps[c]) != 0))
            ck.add("rel.events",
                   f"retrain_after_ps not a multiple of retrain_ps "
                   f"{int(rps[c])} on channel {int(c)}", row=r, hop=h,
                   channel=int(c))
            continue
        failures = extra // quantum
        events = retrain // int(rps[c])
        bound = failures // int(rthr[c])
        bad = m & (events > bound)
        if np.any(bad):
            r, h = _first(bad)
            ck.add("rel.events",
                   f"retrain events {int(events[r, h])} > failures // "
                   f"retrain_threshold = {int(bound[r, h])} on channel "
                   f"{int(c)} — a hop cannot retrain without having "
                   "sampled the failures that caused it", row=r, hop=h,
                   channel=int(c))


def _check_issue(ck: _Checker, issue, monotone: bool):
    if monotone and issue.size > 1 and np.any(np.diff(issue) < 0):
        r = int(np.argmax(np.diff(issue) < 0)) + 1
        ck.add("issue.monotone",
               f"issue_ps decreases at row {r} — the streaming settlement "
               "rule requires non-decreasing issue clocks", row=r)


def _check_carry(ck: _Checker, carry, n_channels: int, hops):
    for f in ("depart_ps", "last_dir", "last_row", "down_until_ps"):
        a = _np(getattr(carry, f))
        if a.shape != (n_channels,):
            ck.add("carry.shape",
                   f"{f} shape {a.shape} != ({n_channels},)")
            return
    ck.expect_dtype(_np(carry.depart_ps), "int64", "depart_ps", code="carry")
    ck.expect_dtype(_np(carry.last_dir), "int8", "last_dir", code="carry")
    ck.expect_dtype(_np(carry.last_row), "int32", "last_row", code="carry")
    ck.expect_dtype(_np(carry.down_until_ps), "int64", "down_until_ps",
                    code="carry")
    dep = _np(carry.depart_ps)
    down = _np(carry.down_until_ps)
    if np.any(dep < 0):
        ck.add("carry.frontier", "depart_ps frontier must be non-negative "
               "(0 = channel never served)", channel=_first(dep < 0)[0])
    if np.any(down < 0):
        ck.add("carry.frontier", "down_until_ps must be non-negative",
               channel=_first(down < 0)[0])
    # a settled down_until marker can extend past the frontier, but a
    # serving frontier behind time 0 or a direction outside the encoding
    # is a corrupted carry
    ld = _np(carry.last_dir)
    if np.any((ld < -1) | (ld > 1)):
        ck.add("carry.frontier", "last_dir must be in {-1, 0, 1}",
               channel=_first((ld < -1) | (ld > 1))[0])
    lr = _np(carry.last_row)
    if np.any(lr < -2):
        ck.add("carry.frontier", "last_row must be >= -2 (-2 = cold)",
               channel=_first(lr < -2)[0])
    seed = _np(carry.join_seed_ps)
    if seed is not None:
        if _np(hops.join_id) is None:
            ck.add("carry.join-seed",
                   "join_seed_ps without join tables on the window's Hops "
                   "(StreamCarry contract)")
        elif seed.shape != (_np(hops.channel).shape[0],):
            ck.add("carry.join-seed",
                   f"join_seed_ps shape {seed.shape} != window rows "
                   f"({_np(hops.channel).shape[0]},) — seeds live in the "
                   "window's group-id space")
        elif np.any(seed < 0):
            ck.add("carry.join-seed", "join_seed_ps must be non-negative",
                   row=_first(seed < 0)[0])


def _check_sf_events(ck: _Checker, ev):
    fab = _np(ev.fab_issue_ps)
    t = fab.shape[0] if fab.ndim == 1 else -1
    if t < 0:
        ck.add("sf.shape", f"fab_issue_ps must be (T,), got {fab.shape}")
        return
    for f in ("cache_hit", "bisnp_mask", "inv_lines", "wb_lines",
              "need_victim", "conflict", "invblk_len"):
        a = _np(getattr(ev, f))
        if a.shape != (t,):
            ck.add("sf.shape", f"{f} shape {a.shape} != ({t},)")
            return
    if np.any(fab < 0):
        ck.add("sf.negative", "fab_issue_ps must be non-negative",
               row=_first(fab < 0)[0])
    for f in ("bisnp_mask", "inv_lines", "wb_lines", "invblk_len"):
        a = _np(getattr(ev, f))
        if np.any(a < 0):
            ck.add("sf.negative", f"{f} must be non-negative",
                   row=_first(a < 0)[0])
    hit = _np(ev.cache_hit).astype(bool)
    snoop = _np(ev.bisnp_mask) != 0
    conflict = _np(ev.conflict).astype(bool)
    bad = hit & snoop & ~conflict
    if np.any(bad):
        ck.add("sf.hit-snoop",
               "cache hit with BISnp traffic but no write conflict — hits "
               "only snoop as upgrade-BISnps (lowering contract)",
               row=_first(bad)[0])


# ---------------------------------------------------------------------------
# Round-bound derivation (host-side; engine.round_bound wraps it)
# ---------------------------------------------------------------------------

def join_depth(join_id, join_wait) -> int:
    """Longest fork/join chain through rows — the join nesting depth.

    ``depth(p) = 0`` for a row that waits on no group, else ``1 + max``
    depth of the rows contributing to the group it waits on (0 when the
    group has no contributors).  Computed by vectorized scatter-max passes,
    each extending every chain by one level, so a DAG stabilizes in at most
    N+1 passes; a cyclic group graph is capped at N.
    """
    if join_id is None or join_wait is None:
        return 0
    jid = np.asarray(join_id).astype(np.int64)
    jw = np.asarray(join_wait).astype(np.int64)
    n = jid.shape[0]
    if n == 0 or not np.any(jw >= 0):
        return 0
    contrib = jid >= 0
    cid = np.where(contrib, jid, 0)
    depth = np.zeros(n, np.int64)
    for _ in range(n + 1):
        gd = np.zeros(n, np.int64)
        np.maximum.at(gd, cid[contrib], depth[contrib])
        new = np.where(jw >= 0, 1 + gd[np.clip(jw, 0, n - 1)], 0)
        if np.array_equal(new, depth):
            return int(depth.max())
        depth = new
    return n  # cyclic group graph: cap the bound


def round_bound(n_hops: int, join_id=None, join_wait=None) -> int:
    """Sufficient fixpoint round budget for a lowered workload:

        bound = (join_depth + 1) * (3*H + 8)

    ``3*H + 8`` covers chain-only layouts; each join level re-gates issue
    times after a full sub-schedule resolves, so a join-depth-D lowering
    needs at most D+1 such phases.
    """
    per_level = 3 * int(n_hops) + 8
    return (join_depth(join_id, join_wait) + 1) * per_level


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def verify_workload(hops, channels, issue_ps, *, carry=None, sf_events=None,
                    reliability=None, chan_pair=None,
                    monotone_issue: bool = False,
                    max_rounds: int | None = None) -> VerifyReport:
    """Validate a lowered ``(Hops, Channels, issue_ps)`` triple statically.

    Optional extensions widen the contract set actually checked:

    carry          `engine.StreamCarry` about to seed this window.
    sf_events      `snoop_filter.SFEvents` the lowering consumed.
    reliability    per-channel sampling tables (the dict shape of
                   `devices._reliability_tables` /
                   `link_layer.broadcast_reliability_tables`) — enables the
                   replay-quantum and ``events <= failures //
                   retrain_threshold`` invariants.
    chan_pair      `FabricGraph.chan_pair` — enables full-duplex pair
                   symmetry and marker-pairing checks.
    monotone_issue require non-decreasing issue clocks (the
                   `streaming.stream_windows` input contract).
    max_rounds     an explicit round budget the caller intends to run the
                   fixpoint with — flagged as ``join.depth`` when it is
                   positive but below the computed `round_bound` (the
                   budget cannot guarantee convergence).  ``None`` / 0
                   (engine default = computed bound) checks nothing.

    Returns a `VerifyReport`; never raises on findings (use `assert_valid`
    or ``report.raise_if_failed()`` for the strict mode).
    """
    ck = _Checker()
    issue = _np(issue_ps)
    n_ch = int(_np(channels.bw_MBps).shape[0])
    _check_channels(ck, channels)
    if chan_pair is not None:
        pair = np.asarray(chan_pair)
        has = pair >= 0
        idx = np.nonzero(has)[0]
        bad = idx[(pair[idx] >= pair.shape[0])
                  | (np.where(pair[idx] < pair.shape[0],
                              pair[np.clip(pair[idx], 0, pair.shape[0] - 1)],
                              -1) != idx)]
        if bad.size:
            ck.add("chan.pair",
                   f"chan_pair asymmetry: pair[pair[{int(bad[0])}]] != "
                   f"{int(bad[0])} — full-duplex retrain mirroring needs "
                   "an involution", channel=int(bad[0]))
    if _check_shapes_dtypes(ck, hops, issue):
        _check_hops(ck, hops, n_ch)
        _check_join(ck, hops)
        _check_reliability(ck, hops, channels, chan_pair=chan_pair,
                           reliability=reliability)
        _check_issue(ck, issue, monotone_issue)
        if carry is not None:
            _check_carry(ck, carry, n_ch, hops)
        if max_rounds is not None and max_rounds > 0:
            jid, jw = _np(hops.join_id), _np(hops.join_wait)
            depth = join_depth(jid, jw)
            bound = round_bound(_np(hops.channel).shape[1], jid, jw)
            if max_rounds < bound:
                ck.add("join.depth",
                       f"round budget {max_rounds} below the computed "
                       f"bound {bound} (join depth {depth}) — the fixpoint "
                       "may report converged=False on traffic the bound "
                       "provably covers")
    if sf_events is not None:
        _check_sf_events(ck, sf_events)
    return VerifyReport(findings=tuple(ck.findings),
                        n_rows=int(_np(hops.channel).shape[0])
                        if _np(hops.channel).ndim == 2 else 0,
                        n_channels=n_ch)


def assert_valid(hops, channels, issue_ps, **kw) -> VerifyReport:
    """Strict one-liner for benchmark setups and test fixtures: verify and
    raise `VerifyError` on any finding; returns the clean report."""
    return verify_workload(hops, channels, issue_ps, **kw).raise_if_failed()


def verify_built(workload, graph=None) -> VerifyReport:
    """Verify a `devices.Workload` (optionally against its source graph's
    ``chan_pair`` / reliability tables) — the benchmark-setup gate."""
    kw = {}
    if graph is not None:
        kw["chan_pair"] = graph.chan_pair
        if np.any(np.asarray(graph.chan_rel_stochastic)):
            kw["reliability"] = dict(
                stochastic=graph.chan_rel_stochastic,
                err_p=graph.chan_flit_err_p,
                flit_size=graph.chan_flit_size,
                flit_payload=graph.chan_flit_payload,
                retry_window=graph.chan_retry_window,
                retrain_threshold=graph.chan_retrain_threshold,
                retrain_ps=graph.chan_retrain_ps,
                rel_seed=graph.chan_rel_seed,
            )
    return verify_workload(workload.hops, workload.channels,
                           workload.issue_ps, **kw)
