"""Plain PyTorch version of one serve round, and CPU emulations of the CUDA
kernels' block decompositions.

One serve round turns the sorted per-item operands of an engine round
(`core.engine._round_inputs`) into each item's ``(start, depart, stall)``:

  1. **lookups** (`last_lookups`): the direction / DRAM row each item reacts
     to is that of the last *serving* (row-managed) item before it in its
     channel segment, and an active item with no active item before it in
     its segment is the segment's head — properties of the ordering alone,
     resolved here with exclusive running-max index gathers
     (``torch.cummax``);
  2. **maps** (`item_maps`): the turnaround gap and row hit/miss penalty
     fold into per-item constants, ``s = ser + row_extra`` is each item's
     total occupancy, and each item gets a (max,+) affine map over the
     channel state ``v = (depart, down)`` — serving items advance
     ``depart`` (and ``down`` when they carry a retrain interval), link-down
     markers only raise ``down``, everything else is the identity; heads
     fold the carried seed state into their constant and kill the incoming
     state, which makes the scan unsegmented;
  3. **scan** (`serve_scan_plain`): one step applies item ``i``'s map to the
     running state,

         v' = M_i (x) v  (+)  c_i        (x) = tropical matmul, (+) = max

     with saturation at ``NEG`` (the tropical -inf sentinel shared with the
     CUDA kernels), here as a whole-array Hillis–Steele inclusive
     composition scan: log2(K) shifted passes of ``torch.maximum``, every sum
     saturated at ``NEG`` as the JAX kernel does
     (``repro/kernels/serve_round/kernel.py``);
  4. **finish** (`finish_round`): the masked outputs from the scanned depart
     states.

`serve_round_ref` is the four in a row: the CPU path, and on the card the
yardstick the fused CUDA kernel is held against.  The scan regroups the
compositions, which is exact on the well-formed maps `item_maps` emits
(head / serving / marker / pass-through): every entry that is finite in
exact (max,+) arithmetic is computed exactly, and every -inf entry stays
within a few times the round's span of ``NEG = -2**62``, far below any real
time.  Times are taken relative to the round's minimum arrival and the seeds
clamped as the reference does (both exact), so the maps equal the
reference's in value.

The CPU emulations run the CUDA kernels' decompositions
(`kernels._three_phase`) with the kernels' block shape by default, so the
tests hold the cross-block structure against the plain version here and not
only on the card: `serve_scan_blocked` the map-only scan's three phases,
`serve_round_blocked` the fused round's five (a blocked "last present" scan
for the lookups, then the blocked map scan).
"""

from __future__ import annotations

import numpy as np
import torch

from .._three_phase import three_phase_scan

NEG = -(2 ** 62)
# block shapes of csrc/serve_round.cu: THREADS threads of ITEMS items each
# in the map-only scan, of ROUND_ITEMS items each in the fused round
THREADS = 256
ITEMS = 8
ROUND_ITEMS = 2
# the one-block passes over the block aggregates: PASS_THREADS threads;
# blocks of the fused round and those passes scan their threads warp by
# warp (WARP lanes)
PASS_THREADS = 1024
WARP = 32
# identity map: M = [[0, NEG], [NEG, 0]], c = NEG
IDENTITY = (0, NEG, NEG, 0, NEG, NEG)


def _compose(m, p):
    """``m`` applied after ``p``: (M, c) . (P, q) = (M (x) P, M (x) q (+) c),
    saturated at NEG after every sum."""
    m00, m01, m10, m11, c0, c1 = m
    p00, p01, p10, p11, q0, q1 = p

    def mx(a, b):
        return torch.clamp_min(torch.maximum(a, b), NEG)

    return (mx(m00 + p00, m01 + p10), mx(m00 + p01, m01 + p11),
            mx(m10 + p00, m11 + p10), mx(m10 + p01, m11 + p11),
            mx(mx(m00 + q0, m01 + q1), c0), mx(mx(m10 + q0, m11 + q1), c1))


def _apply(m, v):
    """Map ``m`` applied to the state ``v = (depart, down)``."""
    m00, m01, m10, m11, c0, c1 = m
    d, w = v

    def mx(a, b):
        return torch.clamp_min(torch.maximum(a, b), NEG)

    return mx(mx(m00 + d, m01 + w), c0), mx(mx(m10 + d, m11 + w), c1)


def serve_scan_plain(m00, m01, m10, m11, c0, c1):
    """Six (K,) int64 map components -> (K,) int64 depart state per item,
    starting from the state ``(NEG, NEG)``."""
    maps = (m00, m01, m10, m11, c0, c1)
    k = m00.shape[0]
    # the identity map fills the shifted-in slots
    ident = IDENTITY
    shift = 1
    while shift < k:
        prev = tuple(torch.cat([torch.full((shift,), f, dtype=x.dtype,
                                           device=x.device), x[:-shift]])
                     for x, f in zip(maps, ident))
        maps = _compose(maps, prev)
        shift *= 2
    a00, a01, _, _, b0, _ = maps
    return torch.clamp_min(torch.maximum(torch.maximum(a00 + NEG, a01 + NEG),
                                         b0), NEG)


def serve_scan_blocked(m00, m01, m10, m11, c0, c1, *, threads=THREADS,
                       items=ITEMS, pass_threads=PASS_THREADS, warp=WARP):
    """`serve_scan_plain`'s function computed as the map-only CUDA scan
    computes it: block aggregates, one pass over them by runs (``warp``
    lanes a warp), a re-scan of each block (its threads scanned in one
    Hillis–Steele scan; `kernels._three_phase.three_phase_scan`)."""
    return three_phase_scan((m00, m01, m10, m11, c0, c1), IDENTITY, _compose,
                            _apply, (NEG, NEG), lambda v: v[0],
                            threads=threads, items=items, carry="runs",
                            pass_threads=pass_threads, pass_warp=warp)


def last_lookups(chan, serving, marker, direction, row, sd_dir, sd_row):
    """``(head, eff_dir, eff_row)`` of every item, by exclusive running-max
    index gathers: ``head`` an active item with no active item before it in
    its channel segment; ``eff_dir`` / ``eff_row`` the direction / DRAM row
    of the last serving (row-managed) item before it in its segment, else
    the channel's seed ``sd_dir`` / ``sd_row``.  int64 values."""
    k = chan.shape[0]
    idx = torch.arange(k, device=chan.device)

    def prev_ix(mask):
        # index of the last item before me satisfying mask (-1 = none)
        inc = torch.cummax(torch.where(mask, idx, -1), dim=0).values
        return torch.cat([inc.new_full((1,), -1), inc[:-1]])

    def in_seg(p):
        return (p >= 0) & (chan[p.clamp_min(0)] == chan)

    row = row.long()
    p_act = prev_ix(serving | marker)
    p_srv = prev_ix(serving)
    p_row = prev_ix(serving & (row >= 0))
    head = (serving | marker) & ~in_seg(p_act)
    eff_dir = torch.where(in_seg(p_srv), direction.long()[p_srv.clamp_min(0)],
                          sd_dir.long())
    eff_row = torch.where(in_seg(p_row), row[p_row.clamp_min(0)],
                          sd_row.long())
    return head, eff_dir, eff_row


def item_maps(serving, marker, arrive, direction, row, ser, turn, rhit,
              rmiss, retrain, sd_dep, sd_down, head, eff_dir, eff_row):
    """Each item's map from its operands and its lookups (elementwise, but
    for the round's minimum arrival ``base``).  Returns ``(maps, aux)``: the
    six (K,) int64 map components (times relative to ``base``), and ``aux =
    (base, s, gap, head)`` for `finish_round`."""
    dirn = direction.long()
    row = row.long()
    gap = torch.where((eff_dir != -1) & (dirn != eff_dir), turn, 0)
    rx = torch.where(row >= 0, torch.where(row == eff_row, rhit, rmiss), 0)
    s = ser + rx

    # times relative to the round's min arrival.  Seed clamps: a depart
    # seed below (base - turn) / a down seed below base can never bind
    # (every start is >= arrive >= base), so clamping is exact
    base = arrive.min()
    arr = arrive - base
    sdep = torch.maximum(sd_dep, base - turn) - base
    sdwn = torch.clamp_min(sd_down, base) - base

    neg = torch.full_like(arr, NEG)
    zero = torch.zeros_like(arr)
    rp = torch.where(retrain > 0, retrain, neg)  # NEG = no retrain

    # serving map: depart' = max(arr+s, depart+gap+s, down+s);
    #              down'   = max(down, depart' + retrain?)
    m00, m01, c0 = gap + s, s, arr + s
    m10 = torch.clamp_min(m00 + rp, NEG)
    m11 = torch.clamp_min(torch.clamp_min(s + rp, 0), NEG)
    c1 = torch.clamp_min(c0 + rp, NEG)
    # marker: depart' = depart; down' = max(down, arr + retrain)
    m00 = torch.where(serving, m00, zero)
    m01 = torch.where(serving, m01, neg)
    c0 = torch.where(serving, c0, neg)
    m10 = torch.where(serving, m10, neg)
    m11 = torch.where(serving, m11, zero)
    c1 = torch.where(serving, c1, torch.where(marker, arr + retrain, neg))
    # heads fold the seed state into c and kill the incoming state — this
    # is what de-segments the scan
    h0 = torch.maximum(torch.maximum(m00 + sdep, m01 + sdwn), c0)
    h1 = torch.maximum(torch.maximum(m10 + sdep, m11 + sdwn), c1)
    c0 = torch.where(head, torch.clamp_min(h0, NEG), c0)
    c1 = torch.where(head, torch.clamp_min(h1, NEG), c1)
    m00 = torch.where(head, neg, m00)
    m01 = torch.where(head, neg, m01)
    m10 = torch.where(head, neg, m10)
    m11 = torch.where(head, neg, m11)
    return (m00, m01, m10, m11, c0, c1), (base, s, gap, head)


def serve_maps(chan, serving, marker, arrive, direction, row, ser, turn,
               rhit, rmiss, retrain, sd_dep, sd_dir, sd_row, sd_down):
    """The plain pre-pass of one sorted serve round (`last_lookups`, then
    `item_maps`); inputs as `serve_round_ref`."""
    return item_maps(serving, marker, arrive, direction, row, ser, turn,
                     rhit, rmiss, retrain, sd_dep, sd_down,
                     *last_lookups(chan, serving, marker, direction, row,
                                   sd_dir, sd_row))


def finish_round(d_rel, arrive, serving, sd_dep, aux):
    """Masked ``(start, depart, stall)`` from the scanned depart states."""
    base, s, gap, head = aux
    d = d_rel + base
    # stall = grant delay the down-until clock added on top of contention
    eff_dep = torch.where(head, sd_dep, torch.cat([sd_dep[:1], d[:-1]]))
    start = d - s
    out_start = torch.where(serving, start, arrive)
    out_depart = torch.where(serving, d, arrive)
    out_stall = torch.where(
        serving, start - torch.maximum(arrive, eff_dep + gap), 0)
    return out_start, out_depart, out_stall


def serve_round_ref(chan, serving, marker, arrive, direction, row, ser, turn,
                    rhit, rmiss, retrain, sd_dep, sd_dir, sd_row, sd_down):
    """One sorted serve round, the plain version (inputs as
    `ops.serve_round`): `serve_maps`, `serve_scan_plain`, `finish_round`.
    Returns int64 ``(start, depart, stall)``."""
    maps, aux = serve_maps(chan, serving, marker, arrive, direction, row,
                           ser, turn, rhit, rmiss, retrain, sd_dep, sd_dir,
                           sd_row, sd_down)
    return finish_round(serve_scan_plain(*maps), arrive, serving, sd_dep, aux)


# "last present" state of the fused kernel's lookups: three groups of
# (present, channel, value) — the last active item (value unused), the last
# serving item (its direction), the last serving item with a row (its row);
# composing keeps the later group wherever it is present
LAST_IDENTITY = (0,) * 9


def _last_compose(m, p):
    out = ()
    for g in range(0, 9, 3):
        has = m[g] > 0
        out += (torch.maximum(m[g], p[g]), torch.where(has, m[g + 1], p[g + 1]),
                torch.where(has, m[g + 2], p[g + 2]))
    return out


def _item_last(chan, serving, marker, direction, row):
    row = row.long()
    return ((serving | marker).long(), chan, torch.zeros_like(chan),
            serving.long(), chan, direction.long(),
            (serving & (row >= 0)).long(), chan, row)


def serve_round_blocked(chan, serving, marker, arrive, direction, row, ser,
                        turn, rhit, rmiss, retrain, sd_dep, sd_dir, sd_row,
                        sd_down, *, threads=THREADS, items=ROUND_ITEMS,
                        pass_threads=PASS_THREADS, warp=WARP):
    """`serve_round_ref`'s function computed as the fused CUDA kernel
    computes it: the lookups as a blocked scan of "last present" states
    (phase A: block aggregates by a tree, with the round's minimum arrival;
    B: one pass over them by runs; C: each item reads the state before it,
    with no gather), the maps from those, the blocked map scan (C: block
    aggregates as the last of the threads' scan; D: one pass by runs; E: a
    re-scan of each block from the threads' exclusive prefixes), and the
    finish."""
    incl = three_phase_scan(
        _item_last(chan, serving, marker, direction, row), LAST_IDENTITY,
        _last_compose, _last_compose, LAST_IDENTITY, lambda v: v,
        threads=threads, items=items, carry="runs", warp=warp,
        pass_threads=pass_threads, pass_warp=warp)
    act_has, act_chan, _, srv_has, srv_chan, srv_dir, row_has, row_chan, \
        row_row = (torch.cat([x.new_zeros(1), x[:-1]]) for x in incl)
    head = (serving | marker) & ~((act_has > 0) & (act_chan == chan))
    eff_dir = torch.where((srv_has > 0) & (srv_chan == chan), srv_dir,
                          sd_dir.long())
    eff_row = torch.where((row_has > 0) & (row_chan == chan), row_row,
                          sd_row.long())
    maps, aux = item_maps(serving, marker, arrive, direction, row, ser, turn,
                          rhit, rmiss, retrain, sd_dep, sd_down, head,
                          eff_dir, eff_row)
    d_rel = three_phase_scan(maps, IDENTITY, _compose, _apply, (NEG, NEG),
                             lambda v: v[0], threads=threads, items=items,
                             carry="runs", block_aggregate="scan", warp=warp,
                             pass_threads=pass_threads, pass_warp=warp)
    return finish_round(d_rel, arrive, serving, sd_dep, aux)


def random_maps(k, seed, *, neg=NEG, prefix=0, one_segment=False):
    """Six (K,) int64 numpy map components of a random well-formed stream:
    the four shapes the ops wrapper emits (head / serving / marker /
    pass-through), with ``prefix`` pass-through items before the first head;
    ``one_segment`` makes every item after the head a serving item, so one
    channel segment spans the whole stream.  ``neg`` is the -inf sentinel
    of the side the stream feeds (the JAX reference uses -2**30).  The test
    and chip-check input of the scan."""
    rng = np.random.default_rng(seed)

    def pick(hi):
        return rng.integers(0, hi, k).astype(np.int64)

    kind = np.ones(k, np.int64) if one_segment else rng.integers(0, 4, k)
    kind[:prefix] = 3
    kind[min(prefix, k - 1)] = 0
    s, gap, r, arr = pick(1 << 16), pick(1 << 16), pick(1 << 16), pick(1 << 20)
    has_r = rng.random(k) < 0.5
    rp = np.where(has_r, r, neg)
    m00, m01, c0 = gap + s, s, arr + s
    m10 = np.maximum(m00 + rp, neg)
    m11 = np.maximum(np.maximum(s + rp, 0), neg)
    c1 = np.maximum(c0 + rp, neg)
    ident = (0, neg, neg, 0, neg, neg)
    marker = (0, neg, neg, 0, neg, arr + r)
    head = (neg, neg, neg, neg, arr, arr + np.where(has_r, r, 0))
    maps = [m00, m01, m10, m11, c0, c1]
    for code, vals in ((2, marker), (3, ident), (0, head)):
        maps = [np.where(kind == code, v, m) for m, v in zip(maps, vals)]
    return maps


def random_round(k, seed, *, n_chan=8, serve=0.6, marker=0.05, tail=0,
                 markers_only=0, warm=False, offset=0):
    """The fifteen operands of one random sorted serve round, as numpy
    arrays in `ops.serve_round`'s order and dtypes: ``k - tail`` valid items
    in channel segments (channels in order, arrivals in order inside each),
    then ``tail`` invalid items, whose channels are -1 (padding) or real, as
    in the engine's trailing dummy segment.  A valid item serves with
    probability ``serve``, is a link-down marker with probability
    ``marker`` and otherwise passes through; the first ``markers_only``
    channels hold markers and pass-through items only.  ``warm`` draws each
    channel's seed frontier (else the cold seeds 0 / -1 / -2 / 0), and
    ``offset`` shifts every time.  The test and chip-check input of the
    fused round."""
    rng = np.random.default_rng(seed)
    nv = k - tail
    span = max(nv, 1) * 300

    def times(n):
        return offset + rng.integers(0, span, n)

    chan = np.sort(rng.integers(0, n_chan, nv))
    arrive = times(nv)
    order = np.lexsort((arrive, chan))
    arrive = arrive[order]
    u = rng.random(nv)
    serving = u < serve
    marker = ~serving & (u < serve + marker)
    quiet = chan < markers_only
    marker = np.where(quiet, u < 0.5, marker)
    serving &= ~quiet
    retrain = np.where(marker | (serving & (rng.random(nv) < 0.1)),
                       rng.integers(1, 8000, nv), 0)
    tail_arrive = np.sort(times(tail))
    chan = np.concatenate([chan, rng.integers(-1, n_chan, tail)])
    arrive = np.concatenate([arrive, tail_arrive])
    serving = np.concatenate([serving, np.zeros(tail, bool)])
    marker = np.concatenate([marker, np.zeros(tail, bool)])
    retrain = np.concatenate([retrain, rng.integers(0, 1 << 20, tail)])
    ch = np.clip(chan, 0, n_chan - 1)
    turn = rng.integers(0, 3000, n_chan)[ch]
    rhit = rng.integers(0, 500, n_chan)[ch]
    rmiss = rng.integers(500, 3000, n_chan)[ch]
    if warm:
        seeds = (times(n_chan), rng.integers(-1, 2, n_chan),
                 rng.integers(-2, 4, n_chan),
                 np.where(rng.random(n_chan) < 0.5, times(n_chan), 0))
    else:
        seeds = (np.zeros(n_chan), np.full(n_chan, -1), np.full(n_chan, -2),
                 np.zeros(n_chan))
    sd_dep, sd_dir, sd_row, sd_down = (x[ch] for x in seeds)
    i64 = np.int64
    return [chan.astype(i64), serving, marker, arrive.astype(i64),
            rng.integers(0, 2, k).astype(np.int8),
            rng.integers(-1, 4, k).astype(np.int32),
            rng.integers(1, 2000, k).astype(i64), turn.astype(i64),
            rhit.astype(i64), rmiss.astype(i64), retrain.astype(i64),
            sd_dep.astype(i64), sd_dir.astype(np.int8),
            sd_row.astype(np.int32), sd_down.astype(i64)]
