"""Mamba-2 SSD chunk scan — the Hopper CUDA kernel's wrapper.

Replaces ``repro/kernels/ssd_chunk/kernel.py::ssd_chunk_pallas`` (the
Pallas TPU kernel, ``pl.pallas_call`` at its line 82).  The kernel is CUDA
C++ for ``sm_90a`` in ``csrc/ssd_chunk.cu``, built with ``nvcc`` at first
use (`kernels._build`) and called through ``ctypes`` on PyTorch's current
stream.

What it computes: `ref.ssd_chunk_ref` (the SSD output y) and
`ref.ssd_final_state` (the recurrent state after the last step) in one
call, up to the order of the float32 sums.  The TPU kernel carried the
(P, N) state across an ordered grid of chunks; CUDA blocks have no order,
so this one runs the reference's decomposition in three phases over chunks
of `CHUNK` steps (chunk states, a walk over the chunks for each chunk's
incoming state, each chunk's output; one phase when S fits one chunk).
`ref.ssd_chunk_blocked` runs the same decomposition on the CPU.  Any S is
taken (the tail chunk is masked); P and N up to `MAX_P` and `MAX_N`.

Bound on the H100: memory.  One layer's prefill of mamba2-1.3b at S = 4096
moves 72.4 MB (x and y in bf16, b, c, dt and the final state) against 13.0
GFLOP of minimal work; this first kernel computes in float32 on the CUDA
cores and recomputes ``C B^T`` for every head.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import load_library

_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"

# the kernel's chunk length and largest head dim and state size (``Q``,
# ``MAX_P`` and ``MAX_N`` in the CUDA source, which the library reports
# back when it is loaded)
CHUNK = 128
MAX_P = 64
MAX_N = 128

# launches of the CUDA kernel, counted by the wrapper (a run resets it to 0
# and reads it back to show that its path went through the kernel)
LAUNCHES = {"ssd_chunk": 0}


def _lib():
    lib = load_library(_SOURCE)
    if lib.ssd_chunk_launch.argtypes is None:
        lib.ssd_chunk_launch.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.ssd_chunk_launch.restype = ctypes.c_int
        for fn in (lib.ssd_chunk_len, lib.ssd_chunk_max_p,
                   lib.ssd_chunk_max_n):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        built = (lib.ssd_chunk_len(), lib.ssd_chunk_max_p(),
                 lib.ssd_chunk_max_n())
        if built != (CHUNK, MAX_P, MAX_N):
            raise RuntimeError(f"ssd_chunk.cu has (chunk, max P, max N) = "
                               f"{built}, the wrapper {(CHUNK, MAX_P, MAX_N)}")
    return lib


def ssd_chunk_kernel(x, dt, a_log, b, c):
    """x (B, S, H, P), b and c (B, S, N), all float32 or all bf16; dt
    (B, S, H) and a_log (H,) float32; contiguous CUDA tensors on one
    device.  Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N)
    float32).  Launches the CUDA kernel on the current stream; raises on
    any tensor it does not take or on a failed launch."""
    ok = (x.dim() == 4 and b.dim() == 3 and c.shape == b.shape
          and b.shape[:2] == x.shape[:2] and dt.shape == x.shape[:3]
          and a_log.shape == x.shape[2:3]
          and x.dtype in (torch.float32, torch.bfloat16)
          and b.dtype == c.dtype == x.dtype
          and dt.dtype == a_log.dtype == torch.float32)
    for t in (x, dt, a_log, b, c):
        ok = ok and t.is_cuda and t.is_contiguous() and t.device == x.device
    if not ok:
        raise ValueError(
            "ssd_chunk takes contiguous CUDA tensors on one device: x (B, S, "
            "H, P), b and c (B, S, N) of one dtype (float32 or bf16), dt "
            "(B, S, H) and a_log (H,) float32")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_chunk takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"got P={p}, N={n}")
    y = torch.empty_like(x)
    if x.numel() == 0 or n == 0:
        return y, torch.zeros((bsz, h, p, n), dtype=torch.float32,
                              device=x.device)
    # every element is written by the kernel
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    n_chunks = -(-s // CHUNK)
    if n_chunks > 1:
        states = torch.empty((bsz, h, n_chunks, p, n), dtype=torch.float32,
                             device=x.device)
        decay = torch.empty((bsz, h, n_chunks), dtype=torch.float32,
                            device=x.device)
        scratch = (states.data_ptr(), decay.data_ptr())
    else:
        scratch = (None, None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().ssd_chunk_launch(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), state.data_ptr(), *scratch,
            int(x.dtype == torch.bfloat16), bsz, s, h, p, n, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["ssd_chunk"] += 1
    return y, state
