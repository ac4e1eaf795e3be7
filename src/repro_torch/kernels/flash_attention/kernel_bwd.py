"""The backward pass of the tensor-core flash attention — the wrapper of its
Hopper CUDA kernel.

Replaces nothing on the TPU: the JAX package defines no VJP for its Pallas
kernel (``repro/kernels/flash_attention/kernel.py::flash_attention_gqa``)
and trains through its plain attention.  The port trains through its
forward kernel (`kernel.flash_attention_kernel`, which writes the rows'
base-2 log-sum-exp on request), and this kernel gives that forward its
gradient: ``csrc/flash_attention_bwd.cu``, CUDA C++ for ``sm_90a`` (wgmma
fed by TMA behind mbarriers, helpers in ``kernels/_hopper.cuh``), built with
``nvcc`` at first use (`kernels._build`) and called through ``ctypes`` on
PyTorch's current stream, four launches a call (the row sums delta, the
float32 dK and dV partials of each key tile's slices, their sum in slice
order, then dQ per query tile), counted once in
``BWD_LAUNCHES["flash_attention_bwd"]``.  The wrapper allocates the
workspace (padded rows and partials) with ``torch.empty``; the slice count
is the kernel's own plan (``flash_attention_bwd_slices``).  It takes bf16
with D a multiple of 16, the types the models train in.  Its plain version
is `ref.flash_attention_bwd_plain`; `ref.flash_attention_bwd_tiled` runs its
decomposition on the CPU.

Bound on the H100: the tensor cores, 10 * D flops per unmasked (query,
key) pair at 989 TFLOP/s bf16 (the kernel does 20 * D: the hi/lo split
products and the dQ pass's recompute).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import load_library
from .kernel import _check, _sqrt_d, uses_tensor_cores

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"

# launches of the backward kernel (one a call of its four), counted by the
# wrapper (a run resets it to 0 and reads it back)
BWD_LAUNCHES = {"flash_attention_bwd": 0}


def _lib_bwd():
    lib = load_library(_SOURCE)
    if lib.flash_attention_bwd_launch.argtypes is None:
        lib.flash_attention_bwd_launch.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 9 + [ctypes.c_float] + [ctypes.c_void_p] * 2
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        lib.flash_attention_bwd_smem.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_smem.restype = ctypes.c_int
        lib.flash_attention_bwd_slices.argtypes = [ctypes.c_int] * 8
        lib.flash_attention_bwd_slices.restype = ctypes.c_int
        lib.flash_attention_bwd_workspace.argtypes = [ctypes.c_int] * 7
        lib.flash_attention_bwd_workspace.restype = ctypes.c_longlong
    return lib


def slices(b, s, t, h, kvh, d, *, causal: bool, window: int) -> int:
    """The number of slices the kernel cuts each key tile's walk into for
    this shape on the current card (its plan: the count whose blocks the
    132 SMs finish soonest, at most 16); raises for a shape it does not
    take."""
    n = _lib_bwd().flash_attention_bwd_slices(b, s, t, h, kvh, d,
                                              int(causal), int(window))
    if n < 1:
        raise RuntimeError(f"flash_attention_bwd has no plan for "
                           f"{(b, s, t, h, kvh, d)}")
    return n


def flash_attention_bwd_kernel(q, k, v, o, do, lse, *, causal: bool = True,
                               window: int = 0, sqrt_d=None, marks=None):
    """The gradient of `flash_attention_kernel` (bf16, D a multiple of 16):
    q, o and do (B, S, H, D), k and v (B, T, KV, D), contiguous bf16 CUDA
    tensors; lse (B, H, S) float32, the forward's base-2 log-sum-exp ->
    (dq, dk, dv) bf16 in the inputs' layouts.  Launches the four kernels of
    ``csrc/flash_attention_bwd.cu`` on the current stream (one count);
    raises on any tensor it does not take or on a failed launch.
    ``sqrt_d``: the forward's divisor of the scores (default: the square
    root of D, rounded to float32).  ``marks``:
    five ``torch.cuda.Event`` s, each recorded once already, that the call
    records before its first launch and after each of the four, to time
    them."""
    b, s, t, h, kvh, d = _check(q, k, v, (o, do))
    if not (uses_tensor_cores(q.dtype, d) and lse.is_cuda
            and lse.dtype == torch.float32 and lse.is_contiguous()
            and tuple(lse.shape) == (b, h, s) and lse.device == q.device):
        raise ValueError(
            f"flash_attention's backward kernel takes bf16 with D a "
            f"multiple of 16 and a float32 (B, H, S) lse; got {q.dtype}, "
            f"D={d}, lse {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    shape = (b, s, t, h, kvh, d)
    with torch.cuda.device(q.device):
        lib = _lib_bwd()
        n = slices(*shape, causal=causal, window=window)
        ws = torch.empty(lib.flash_attention_bwd_workspace(*shape, n),
                         dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        events = None if marks is None else (ctypes.c_void_p * 5)(
            *(e.cuda_event for e in marks))
        err = lib.flash_attention_bwd_launch(
            *(x.data_ptr() for x in (q, k, v, o, do, lse, dq, dk, dv, ws)),
            *shape, int(causal), int(window), n,
            _sqrt_d(d) if sqrt_d is None else float(sqrt_d), stream, events)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    BWD_LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
