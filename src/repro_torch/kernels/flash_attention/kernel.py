"""Causal / sliding-window GQA flash attention — the wrapper of its two
Hopper CUDA kernels.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_gqa``
(the Pallas TPU kernel, ``pl.pallas_call`` at its line 93).  Both kernels
are CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use
(`kernels._build`) and called through ``ctypes`` on PyTorch's current
stream.  The wrapper picks one by dtype and head dim:

* bf16 with D a multiple of 16 (the served models' case):
  ``csrc/flash_attention_tc.cu``, FlashAttention-2 on the tensor cores
  (``mma.sync``), 128-row query tiles, the weights split hi/lo against V;
  counted in ``LAUNCHES["flash_attention_tc"]``;
* float32, or bf16 with another D: ``csrc/flash_attention.cu``, float32 on
  the CUDA cores, 64-row query tiles; counted in
  ``LAUNCHES["flash_attention"]``.

Nothing falls back from one to the other.

What it computes: ``softmax(q k^T / sqrt(D))`` under the causal mask and an
optional sliding window, times ``v``, with float32 scores, softmax and PV
product and the output in q's dtype — `ref.flash_attention_ref` up to the
order of the float32 sums.  It reads the model's layout directly (q and the
output (B, S, H, D), k and v (B, T, KV, D)), grouping the query heads per KV
head without replicating K and V.  One block per (batch, query head, query
tile) walks the KV tiles in order with the online-softmax state in
registers, and skips the tiles that lie wholly outside the causal window.
Any S <= T is taken.  `ref.flash_attention_tiled` runs either kernel's
algorithm on the CPU (``split=True`` for the tensor-core one).

Bound on the H100: the tensor cores, 4 * D flops per unmasked (query, key)
pair at 989 TFLOP/s bf16.

The gradient (`ops.flash_attention` under autograd): the tensor-core kernel
writes the rows' base-2 log-sum-exp on request (``return_lse=True``) for
the backward kernel (`kernel_bwd`).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .._build import load_library

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_SOURCE_TC = _SOURCE.with_name("flash_attention_tc.cu")

# launches of each CUDA kernel, counted by the wrapper (a run resets them to
# 0 and reads them back to show that its path went through the kernels)
LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0}

DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = load_library(_SOURCE)
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _lib_tc():
    lib = load_library(_SOURCE_TC)
    if lib.flash_attention_tc_launch.argtypes is None:
        lib.flash_attention_tc_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_attention_tc_launch.restype = ctypes.c_int
    return lib


def uses_tensor_cores(dtype, d: int) -> bool:
    """Whether a call of this dtype and head dim takes the tensor-core
    kernel (else the CUDA-core one)."""
    return dtype == torch.bfloat16 and d % 16 == 0


def _check(q, k, v, others=()):
    """(b, s, t, h, kvh, d) of a call the kernels take; raises
    otherwise."""
    ok = q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
    for x in (q, k, v, *others):
        ok = ok and (x.is_cuda and x.dtype == q.dtype and x.dtype in DTYPES
                     and x.is_contiguous() and x.device == q.device)
    ok = ok and all(x.shape == q.shape for x in others)
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
    return b, s, t, h, kvh, d


def _sqrt_d(d: int) -> float:
    return float(torch.tensor(math.sqrt(d), dtype=torch.float32))


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           return_lse: bool = False):
    """q: (B, S, H, D); k, v: (B, T, KV, D); contiguous CUDA tensors of one
    dtype (float32 or bf16) on one device, with S <= T, H a multiple of KV,
    D a multiple of 4 and at most 256 -> (B, S, H, D) in q's dtype.
    Launches the tensor-core kernel for bf16 with D a multiple of 16, the
    CUDA-core kernel otherwise (`uses_tensor_cores`), on the current
    stream; raises on any tensor it does not take or on a failed launch.
    ``return_lse`` (the tensor-core kernel only): also the rows' base-2
    log-sum-exp, float32 (B, H, S), for the backward kernel."""
    b, s, t, h, kvh, d = _check(q, k, v)
    tc = uses_tensor_cores(q.dtype, d)
    if return_lse and not tc:
        raise ValueError(
            f"flash_attention writes the log-sum-exp only from the "
            f"tensor-core kernel (bf16, D a multiple of 16); got {q.dtype}, "
            f"D={d}")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    sqrt_d = _sqrt_d(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            err = _lib_tc().flash_attention_tc_launch(
                *ptrs, None if lse is None else lse.data_ptr(), b, s, t, h,
                kvh, d, int(causal), int(window), sqrt_d, stream)
        else:
            err = _lib().flash_attention_launch(
                *ptrs, int(q.dtype == torch.bfloat16), b, s, t, h, kvh, d,
                int(causal), int(window), sqrt_d, stream)
    name = "flash_attention_tc" if tc else "flash_attention"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return (out, lse) if return_lse else out

