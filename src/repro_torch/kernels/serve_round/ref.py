"""Plain PyTorch version of the serve-round (max,+) affine-map scan.

One step applies item ``i``'s (max,+) affine map to the running channel
state ``v = (depart, down)``:

    v' = M_i (x) v  (+)  c_i        (x) = tropical matmul, (+) = max

with saturation at ``NEG`` (the tropical -inf sentinel shared with the CUDA
kernel).  This version is a whole-array Hillis–Steele inclusive composition
scan: log2(K) shifted passes of ``torch.maximum``, every sum saturated at
``NEG`` as the JAX kernel does (``repro/kernels/serve_round/kernel.py``).
It regroups the compositions, which is exact on the well-formed maps the ops
wrapper emits (head / serving / marker / pass-through): every entry that is
finite in exact (max,+) arithmetic is computed exactly, and every -inf entry
stays within a few times the round's span of ``NEG = -2**62``, far below
any real time.  The CPU path and the tests use it; on the card it is only
the yardstick the kernel is held against.

`serve_scan_blocked` runs the CUDA kernel's own three-phase block
decomposition (`kernels._three_phase`) on the CPU, with the kernel's block
shape by default, so the tests hold the cross-block structure against the
plain version here and not only on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .._three_phase import three_phase_scan

NEG = -(2 ** 62)
# block shape of csrc/serve_round.cu: THREADS threads of ITEMS items each
THREADS = 256
ITEMS = 8
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


def serve_scan_ref(m00, m01, m10, m11, c0, c1):
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
                       items=ITEMS):
    """`serve_scan_ref`'s function computed as the CUDA kernel computes it:
    block aggregates, one pass over them, a re-scan of each block
    (`kernels._three_phase.three_phase_scan`)."""
    return three_phase_scan((m00, m01, m10, m11, c0, c1), IDENTITY, _compose,
                            _apply, (NEG, NEG), lambda v: v[0],
                            threads=threads, items=items)


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
