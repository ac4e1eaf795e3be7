"""Plain PyTorch version of the RG-LRU scan kernel, and a CPU emulation of
the kernel's blocked algorithm.

The counterpart of ``repro/kernels/rglru_scan/ref.py::rglru_scan_ref``: the
linear recurrence ``h_t = a_t * h_{t-1} + b_t`` over the sequence axis of
(B, S, D) float32 tensors, from ``h_{-1} = 0``.  The reference takes it as a
parallel associative scan; the plain version here walks the sequence in
order, one multiply and one add per step (each rounding once), which is the
definition itself.  The CPU path and the tests use it; on the card it is the
yardstick the kernel is held against.

`rglru_scan_blocked` computes the CUDA kernel's chunk carries with
whole-tensor PyTorch: the sequence cut into chunks, each chunk's affine map
``h -> A*h + B`` (phase 1), a walk over the chunks in order giving each its
incoming state (phase 2), and a re-scan of every chunk from that state
(phase 3).  The kernel makes the same maps, walks them in the same order and
re-scans from the same states, tile by tile in one pass, so at the kernel's
``chunk`` the two are equal bit for bit.  With one chunk it is the plain
version, bit for bit.
"""

from __future__ import annotations

import torch

# the CUDA kernel's shape (csrc/rglru_scan.cu): chunks of CHUNK steps, one
# block walking the sequence in tiles of TILE steps (16 chunks)
CHUNK = 16
TILE = 256


def _check(a, b):
    if a.shape != b.shape or a.dim() != 3:
        raise ValueError(f"rglru_scan takes two (B, S, D) tensors of one "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")


def rglru_scan_ref(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1, in float32; (B, S, D)."""
    _check(a, b)
    a = a.float()
    b = b.float()
    out = torch.empty_like(a)
    h = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_blocked(a, b, chunk: int):
    """The kernel's chunk decomposition over chunks of ``chunk`` steps (the
    last chunk may be short), in float32; (B, S, D)."""
    _check(a, b)
    a = a.float()
    b = b.float()
    bsz, s, d = a.shape
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    # padded steps are the identity map (a = 1, b = 0)
    ac = torch.cat([a, a.new_ones(bsz, pad, d)], 1).view(bsz, n_chunks,
                                                         chunk, d)
    bc = torch.cat([b, b.new_zeros(bsz, pad, d)], 1).view(bsz, n_chunks,
                                                          chunk, d)
    # phase 1: each chunk's map h -> agg_a * h + agg_b
    agg_a = ac.new_ones(bsz, n_chunks, d)
    agg_b = ac.new_zeros(bsz, n_chunks, d)
    for t in range(chunk):
        agg_a = agg_a * ac[:, :, t]
        agg_b = ac[:, :, t] * agg_b + bc[:, :, t]
    # phase 2: the state entering each chunk
    carry = torch.empty_like(agg_a)
    h = a.new_zeros(bsz, d)
    for c in range(n_chunks):
        carry[:, c] = h
        h = agg_a[:, c] * h + agg_b[:, c]
    # phase 3: every chunk re-scanned from its incoming state
    out = torch.empty_like(ac)
    h = carry
    for t in range(chunk):
        h = ac[:, :, t] * h + bc[:, :, t]
        out[:, :, t] = h
    return out.view(bsz, n_chunks * chunk, d)[:, :s]
