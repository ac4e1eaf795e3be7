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

`segmented_depart_blocked` computes the same function by the CUDA kernel's
three-phase block decomposition (`kernels._three_phase`), so the tests hold
the cross-block structure against the plain version on the CPU.  The CPU
path and the tests use these; on the card the plain version is only the
yardstick the kernel is held against.
"""

from __future__ import annotations

import numpy as np
import torch

from .._three_phase import three_phase_scan

NEG = -(2 ** 62)
# block shape of csrc/link_contention.cu: THREADS threads of ITEMS items each
THREADS = 256
ITEMS = 8
IDENTITY = (NEG, 0, False)  # (c, m, reset): f(x) = max(NEG, x)


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


def segmented_depart_blocked(chan, arrive, ser, *, threads=THREADS,
                             items=ITEMS):
    """`segmented_depart_ref`'s function computed as the CUDA kernel
    computes it: block aggregates, one pass over them, a re-scan of each
    block."""
    maps = item_maps(chan, arrive.long(), ser.long())
    return three_phase_scan(maps, IDENTITY, _compose, _apply, (NEG,),
                            lambda v: v[0], threads=threads, items=items)


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
