"""RG-LRU linear recurrence — the Hopper CUDA kernel's wrapper.

Replaces ``repro/kernels/rglru_scan/kernel.py::rglru_scan_pallas`` (the
Pallas TPU kernel, ``pl.pallas_call`` at its line 62).  The kernel is CUDA
C++ for ``sm_90a`` in ``csrc/rglru_scan.cu``, built with ``nvcc`` at first
use (`kernels._build`) and called through ``ctypes`` on PyTorch's current
stream.

What it computes: ``h_t = a_t * h_{t-1} + b_t`` over the sequence axis of
(B, S, D) float32 tensors.  The TPU kernel carried ``h`` across an ordered
grid of sequence chunks; CUDA blocks have no order, so here one block owns
32 adjacent features of one batch row and walks the whole sequence in tiles
of 16 chunks of `chunk()` steps: each warp composes its chunk's map from a
and b held in registers, one warp walks the chunk maps in order, and each
warp re-scans its chunk from its incoming state, while the next tile loads.
One launch; `ref.rglru_scan_blocked(a, b, chunk())` computes the same
chunk carries in the same order on the CPU, and the kernel equals it bit
for bit.  Any S and D are taken.

Bound on the H100: memory, 12 B per element (a and b read, h written),
which is what the kernel moves.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import load_library

_SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"

# launches of the CUDA kernel, counted by the wrapper (a run resets it to 0
# and reads it back to show that its path went through the kernel)
LAUNCHES = {"rglru_scan": 0}


def _lib():
    lib = load_library(_SOURCE)
    if lib.rglru_scan_launch.argtypes is None:
        lib.rglru_scan_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.rglru_scan_launch.restype = ctypes.c_int
        lib.rglru_scan_chunk.argtypes = []
        lib.rglru_scan_chunk.restype = ctypes.c_int
        lib.rglru_scan_tile.argtypes = []
        lib.rglru_scan_tile.restype = ctypes.c_int
    return lib


def chunk() -> int:
    """Sequence steps one chunk of the kernel covers (set in the CUDA
    source; builds it)."""
    return int(_lib().rglru_scan_chunk())


def tile() -> int:
    """Sequence steps one block walks per tile (set in the CUDA source;
    builds it)."""
    return int(_lib().rglru_scan_tile())


def rglru_scan_kernel(a, b):
    """a, b: (B, S, D) float32 contiguous CUDA tensors on one device ->
    h (B, S, D) float32.  Launches the CUDA kernel on the current stream;
    raises on any tensor it does not take or on a failed launch."""
    ok = a.dim() == 3 and a.shape == b.shape
    for x in (a, b):
        ok = ok and (x.is_cuda and x.dtype == torch.float32
                     and x.is_contiguous() and x.device == a.device)
    if not ok:
        raise ValueError("rglru_scan takes two contiguous (B, S, D) float32 "
                         "CUDA tensors of one shape on one device")
    bsz, s, d = a.shape
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rglru_scan_launch(a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), bsz, s, d, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["rglru_scan"] += 1
    return out
