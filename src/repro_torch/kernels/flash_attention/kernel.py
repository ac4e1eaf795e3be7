"""Causal / sliding-window GQA flash attention — the Hopper CUDA kernel's
wrapper.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_gqa``
(the Pallas TPU kernel, ``pl.pallas_call`` at its line 93).  The kernel is
CUDA C++ for ``sm_90a`` in ``csrc/flash_attention.cu``, built with ``nvcc``
at first use (`kernels._build`) and called through ``ctypes`` on PyTorch's
current stream.

What it computes: ``softmax(q k^T / sqrt(D))`` under the causal mask and an
optional sliding window, times ``v``, with float32 scores, softmax and PV
product and the output in q's dtype — `ref.flash_attention_ref` up to the
order of the float32 sums.  It reads the model's layout directly (q and the
output (B, S, H, D), k and v (B, T, KV, D)), grouping the query heads per KV
head without replicating K and V.  One block per (batch, query head, 64-row
query tile) walks the KV tiles in order with the online-softmax state in
registers, and skips the tiles that lie wholly outside the causal window.
Any S <= T is taken.

Bound on the H100: the tensor cores, 4 * D flops per unmasked (query, key)
pair at 989 TFLOP/s bf16.  This first kernel computes in float32 on the CUDA
cores, so it runs far from that bound.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .._build import load_library

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# launches of the CUDA kernel, counted by the wrapper (a run resets it to 0
# and reads it back to show that its path went through the kernel)
LAUNCHES = {"flash_attention": 0}

DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = load_library(_SOURCE)
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, D); k, v: (B, T, KV, D); contiguous CUDA tensors of one
    dtype (float32 or bf16) on one device, with S <= T, H a multiple of KV,
    D a multiple of 4 and at most 256 -> (B, S, H, D) in q's dtype.
    Launches the CUDA kernel on the current stream; raises on any tensor it
    does not take or on a failed launch."""
    ok = q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
    for x in (q, k, v):
        ok = ok and (x.is_cuda and x.dtype == q.dtype and x.dtype in DTYPES
                     and x.is_contiguous() and x.device == q.device)
    if ok:
        b, s, h, d = q.shape
        t, kvh = k.shape[1], k.shape[2]
        ok = (k.shape[0] == b and k.shape[3] == d and 1 <= s <= t
              and h % kvh == 0 and d % 4 == 0 and 4 <= d <= 256)
    if not ok:
        raise ValueError(
            "flash_attention takes contiguous CUDA q (B, S, H, D) and k, v "
            "(B, T, KV, D) of one dtype (float32 or bf16) on one device, "
            "with S <= T, H a multiple of KV and D a multiple of 4 in "
            f"[4, 256]; got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, s, t, h, kvh, d, int(causal),
            int(window), float(torch.tensor(math.sqrt(d), dtype=torch.float32)),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
