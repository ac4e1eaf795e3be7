"""Plain PyTorch version of the segmented depart scan.

Over a stream sorted by channel, each item departs at

    depart_i = max(arrive_i, depart_{i-1} on the same channel) + ser_i

Item ``i`` is the map ``f_i(x) = max(c_i, x + m_i)`` with ``c = arrive +
ser`` and ``m = ser``, and a *head* (the first item of its channel segment)
resets: ``f_i(x) = c_i``.  Maps are triples ``(c, m, reset)`` and compose as

    g after f = g                                    if g resets
              = (max(g.c, f.c + g.m), f.m + g.m, f.reset)   otherwise

`segmented_depart_ref` is a whole-array Hillis–Steele inclusive scan of
those maps: log2(K) shifted passes of elementwise PyTorch.  Everything is
int64 with no rebase: (max,+) with a reset is associative in exact integer
arithmetic, so any grouping gives the same departures, and there is no
span limit.  The first item of the stream is always a head, so it departs
at ``arrive + ser`` (the running state starts at ``NEG``, no departure).
The reference's sequential version (``repro/kernels/link_contention/ref.py``)
instead starts from ``(channel -1, depart 0)``; it differs from this one
only for a leading run of channel -1 with a negative arrival, which its
``depart_times`` never feeds it (it rebases every arrival to >= 0).

`segmented_depart_lookback` computes the same function as the CUDA kernel
computes it, a single-pass scan with decoupled look-back: the tiles in
order, each scanned as a block of the kernel scans it and given its
incoming depart by `look_back` from what its predecessors have published,
drawn from a seeded generator.  The tests hold it against the plain
version on the CPU.  The CPU path and the tests use these; on the card the
plain version is only the yardstick the kernel is held against.
"""

from __future__ import annotations

import numpy as np
import torch

from .._three_phase import _block_scan

NEG = -(2 ** 62)
# tile shape of csrc/link_contention.cu: THREADS threads of ITEMS items
# each; its warps are WARP lanes wide, and its look-back warp reads WARP
# predecessors at a time
THREADS = 256
ITEMS = 8
WARP = 32
IDENTITY = (NEG, 0, False)  # (c, m, reset): f(x) = max(NEG, x)
# what a tile has published: its aggregate only, or its inclusive depart
AGGREGATE, PREFIX = 1, 2


def _compose(g, f):
    """``g`` applied after ``f``."""
    gc, gm, gr = g
    fc, fm, fr = f
    return (torch.where(gr, gc, torch.maximum(gc, fc + gm)),
            torch.where(gr, gm, fm + gm), gr | fr)


def _apply(f, v):
    fc, fm, fr = f
    (x,) = v
    return (torch.where(fr, fc, torch.maximum(fc, x + fm)),)


def item_maps(chan, arrive, ser):
    """The (c, m, reset) map of every item of a channel-sorted stream."""
    head = torch.ones_like(chan, dtype=torch.bool)
    head[1:] = chan[1:] != chan[:-1]
    return arrive + ser, ser, head


def segmented_depart_ref(chan, arrive, ser):
    """(K,) sorted int channel, (K,) int64 arrive / ser -> (K,) int64
    depart: a whole-array segmented Hillis–Steele scan."""
    maps = item_maps(chan, arrive.long(), ser.long())
    k = chan.shape[0]
    shift = 1
    while shift < k:
        prev = tuple(torch.cat([torch.full((shift,), v, dtype=x.dtype,
                                           device=x.device), x[:-shift]])
                     for x, v in zip(maps, IDENTITY))
        maps = _compose(maps, prev)
        shift *= 2
    return _apply(maps, (torch.full_like(maps[0], NEG),))[0]


def look_back(status, agg_c, agg_m, incl):
    """The depart coming into the tile after ``status``'s last, as the
    kernel's look-back warp computes it, and the windows it read.

    ``status`` (n,) holds what each tile before it has published
    (`AGGREGATE` or `PREFIX`), ``agg_c`` / ``agg_m`` their aggregate maps
    (which never reset: a tile with a head publishes its prefix) and
    ``incl`` their inclusive departs (read where the status is `PREFIX`).
    Lane ``l`` of a window of `WARP` reads the tile ``l`` before the
    window's nearest; the window is composed by a shuffle-down tree (lane
    ``l`` absorbs lane ``l + off`` for ``off`` = 1, 2, 4, ...), nearest
    applied last, and the walk stops at the first window that holds a
    prefix (a tile before the first is a prefix of `NEG`).  ``status`` is
    not empty: tile 0 never looks back, since the stream's first item is a
    head."""
    lane = torch.arange(WARP)
    acc = tuple(torch.tensor(v) for v in IDENTITY)
    base, windows = status.shape[0] - 1, 0
    while not acc[2]:
        j = base - lane
        before = j < 0
        jj = j.clamp(min=0)
        pref = before | (status[jj] == PREFIX)
        f = (torch.where(pref, torch.where(before, NEG, incl[jj]), agg_c[jj]),
             torch.where(pref, 0, agg_m[jj]), pref)
        off = 1
        while off < WARP:
            o = tuple(torch.roll(x, -off) for x in f)
            f = tuple(torch.where(lane + off < WARP, y, x)
                      for x, y in zip(f, _compose(f, o)))
            off *= 2
        acc = _compose(acc, tuple(x[0] for x in f))
        base, windows = base - WARP, windows + 1
    return int(acc[0]), windows


def segmented_depart_lookback(chan, arrive, ser, *, threads=THREADS,
                              items=ITEMS, seed=0):
    """`segmented_depart_ref`'s function computed as the CUDA kernel
    computes it: tiles of ``threads * items`` items, in tile order.

    Each thread composes its ``items`` consecutive maps, the tile scans the
    thread aggregates warp by warp (`_three_phase._block_scan`), and every
    tile but the first takes its incoming depart from `look_back` over what
    its predecessors have published by then: a tile
    with a head its inclusive depart always, any other tile its aggregate
    only or its inclusive depart too, drawn per predecessor and look-back
    from a ``torch.Generator`` seeded with ``seed``.  Seed 0 draws no early
    prefix, the longest look-backs; another seed first draws the chance of
    one.  Then each thread applies its exclusive prefix to the tile's
    incoming depart and walks its items."""
    maps = item_maps(chan, arrive.long(), ser.long())
    k = chan.shape[0]
    tile = threads * items
    nt = -(-k // tile)
    pad = nt * tile - k
    m = tuple(torch.cat([x, torch.full((pad,), v, dtype=x.dtype)])
              .view(nt, threads, items) for x, v in zip(maps, IDENTITY))
    live = (torch.arange(nt * tile) < k).view(nt, threads, items)

    a = tuple(torch.full((nt, threads), v, dtype=x.dtype)
              for v, x in zip(IDENTITY, m))
    for j in range(items):
        mj = tuple(x[..., j] for x in m)
        a = tuple(torch.where(live[..., j], y, x)
                  for x, y in zip(a, _compose(mj, a)))
    inc, excl = _block_scan(a, IDENTITY, _compose, WARP)
    agg_c, agg_m, agg_r = (x[:, -1] for x in inc)

    gen = torch.Generator().manual_seed(seed)
    p_prefix = float(torch.rand((), generator=gen)) if seed else 0.0
    incoming = torch.full((nt,), NEG, dtype=torch.int64)
    incl = torch.empty(nt, dtype=torch.int64)
    for t in range(nt):
        if t:  # tile 0 starts with a head and looks back at nothing
            early = torch.rand(t, generator=gen) < p_prefix
            status = torch.where(agg_r[:t] | early, PREFIX, AGGREGATE)
            incoming[t] = look_back(status, agg_c[:t], agg_m[:t],
                                    incl[:t])[0]
        incl[t] = _apply((agg_c[t], agg_m[t], agg_r[t]), (incoming[t],))[0]

    v = incoming[:, None].expand(nt, threads)
    v = torch.where(torch.arange(threads) == 0, v, _apply(excl, (v,))[0])
    out = []
    for j in range(items):
        mj = tuple(x[..., j] for x in m)
        v = torch.where(live[..., j], _apply(mj, (v,))[0], v)
        out.append(v)
    return torch.stack(out, dim=-1).reshape(-1)[:k]


def random_stream(k, seed, *, n_chan=7, offset=0, one_segment=False,
                  singletons=False, lead_minus_one=0):
    """A channel-sorted numpy stream ``(chan int64, arrive, ser)`` sorted by
    (channel, arrival) as the engine sorts a round: ``n_chan`` channels
    (``one_segment``: one; ``singletons``: every item its own channel),
    arrivals offset by ``offset``, and a leading run of ``lead_minus_one``
    items on channel -1.  The test and chip-check input of the scan."""
    rng = np.random.default_rng(seed)
    if singletons:
        chan = np.arange(k, dtype=np.int64)
    elif one_segment:
        chan = np.zeros(k, np.int64)
    else:
        chan = rng.integers(0, n_chan, k).astype(np.int64)
    chan[:lead_minus_one] = -1
    arrive = rng.integers(0, 1 << 20, k).astype(np.int64) + offset
    order = np.lexsort((arrive, chan))
    ser = rng.integers(0, 1000, k).astype(np.int64)
    return chan[order], arrive[order], ser
