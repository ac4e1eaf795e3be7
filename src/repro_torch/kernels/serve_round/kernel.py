"""Serve-round (max,+) affine-map scan — the Hopper CUDA kernel's wrapper.

Replaces ``repro/kernels/serve_round/kernel.py::serve_scan`` (the Pallas TPU
kernel, ``pl.pallas_call`` at its line 104).  The kernel is CUDA C++ for
``sm_90a`` in ``csrc/serve_round.cu``, built with ``nvcc`` at first use
(`kernels._build`) and called through ``ctypes`` on PyTorch's current
stream.

What it computes: the inclusive scan of item maps ``v' = M_i (x) v (+) c_i``
over the channel state ``v = (depart, down)`` from ``(NEG, NEG)``, returning
each item's ``depart`` — exactly `ref.serve_scan_ref`, bit for bit.  The TPU
kernel carried the state from block to block through scratch memory,
relying on its grid running in order; CUDA blocks have no order, so this one
is a three-phase scan:

  (A) each block composes its items' maps, in order, into one aggregate;
  (B) one block applies the aggregates in order to ``(NEG, NEG)``, giving
      each block its incoming state;
  (C) each block re-scans its items from that state and writes ``depart``.

Every sum is saturated at ``NEG = -2**62`` (int64 end to end, no span
limit).  Compositions are regrouped inside a block and across blocks, which
is exact on the well-formed maps `ops.serve_maps` emits (see `ref`).

Bound on the H100: memory.  The function must read six int64 components and
write one per item, 56 B; at K = 268,800 that is 15 MB, about 4.5 µs at
3.35 TB/s.  The three-phase design moves about 104 B per item (A and C
each read the maps once, C holding a thread's maps in registers between
its aggregate and its apply loop) in three dependent launches, with one 256-thread block per
SM at that size, so it is bound by latency, not bandwidth: on an H100 SXM
(700 W) it takes 28 µs of device time at K = 268,800 (`chip_smoke.py`).
The design does nothing about that yet: a single-pass decoupled look-back
scan is later work.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import load_library

_SOURCE = Path(__file__).resolve().parent / "csrc" / "serve_round.cu"

# launches of the CUDA kernel, counted by the wrapper (a run resets it to 0
# and reads it back to show that its main path went through the kernel)
LAUNCHES = {"serve_scan": 0}


def _lib():
    lib = load_library(_SOURCE)
    fn = lib.serve_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.serve_scan_block_items.argtypes = []
        lib.serve_scan_block_items.restype = ctypes.c_longlong
    return lib


def block_items() -> int:
    """Items one CUDA block scans (set in the CUDA source; builds it)."""
    return int(_lib().serve_scan_block_items())


def serve_scan(m00, m01, m10, m11, c0, c1):
    """Six (K,) int64 CUDA map components -> (K,) int64 depart state per
    item.  Launches the CUDA kernel (three phases) on the current stream;
    raises on any tensor it does not take or on a failed launch."""
    maps = (m00, m01, m10, m11, c0, c1)
    k = m00.shape[0]
    for x in maps:
        if not (x.is_cuda and x.dtype == torch.int64 and x.dim() == 1
                and x.shape[0] == k and x.is_contiguous()
                and x.device == m00.device):
            raise ValueError("serve_scan takes six contiguous 1-D int64 "
                             "CUDA tensors of one length on one device")
    out = torch.empty_like(m00)
    if k == 0:
        return out
    n_blocks = -(-k // block_items())
    agg = torch.empty(6 * n_blocks, dtype=torch.int64, device=m00.device)
    state = torch.empty(2 * n_blocks, dtype=torch.int64, device=m00.device)
    with torch.cuda.device(m00.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().serve_scan_launch(
            *(x.data_ptr() for x in maps), out.data_ptr(), k,
            agg.data_ptr(), state.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"serve_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["serve_scan"] += 1
    return out
