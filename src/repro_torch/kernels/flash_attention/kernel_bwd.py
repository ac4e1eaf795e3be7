"""The backward pass of the tensor-core flash attention — the wrapper of its
Hopper CUDA kernel.

Replaces nothing on the TPU: the JAX package defines no VJP for its Pallas
kernel (``repro/kernels/flash_attention/kernel.py::flash_attention_gqa``)
and trains through its plain attention.  The port trains through its
forward kernel (`kernel.flash_attention_kernel`, which writes the rows'
base-2 log-sum-exp on request), and this kernel gives that forward its
gradient: ``csrc/flash_attention_bwd.cu``, CUDA C++ for ``sm_90a``, built
with ``nvcc`` at first use (`kernels._build`) and called through ``ctypes``
on PyTorch's current stream, three launches a call (the row sums delta,
then dK and dV per key tile, then dQ per query tile), counted once in
``BWD_LAUNCHES["flash_attention_bwd"]``.  It takes bf16 with D a multiple
of 16, the types the models train in.  Its plain version is
`ref.flash_attention_bwd_plain`.

Bound on the H100: the tensor cores, 10 * D flops per unmasked (query,
key) pair at 989 TFLOP/s bf16.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import load_library
from .kernel import _check, _sqrt_d, uses_tensor_cores

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"

# launches of the backward kernel (one a call of its three), counted by the
# wrapper (a run resets it to 0 and reads it back)
BWD_LAUNCHES = {"flash_attention_bwd": 0}


def _lib_bwd():
    lib = load_library(_SOURCE)
    if lib.flash_attention_bwd_launch.argtypes is None:
        lib.flash_attention_bwd_launch.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        lib.flash_attention_bwd_smem.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_bwd_smem.restype = ctypes.c_int
    return lib


def flash_attention_bwd_kernel(q, k, v, o, do, lse, *, causal: bool = True,
                               window: int = 0):
    """The gradient of `flash_attention_kernel` (bf16, D a multiple of 16):
    q, o and do (B, S, H, D), k and v (B, T, KV, D), contiguous bf16 CUDA
    tensors; lse (B, H, S) float32, the forward's base-2 log-sum-exp ->
    (dq, dk, dv) bf16 in the inputs' layouts.  Launches the three kernels of
    ``csrc/flash_attention_bwd.cu`` on the current stream (one count);
    raises on any tensor it does not take or on a failed launch."""
    b, s, t, h, kvh, d = _check(q, k, v, (o, do))
    if not (uses_tensor_cores(q.dtype, d) and lse.is_cuda
            and lse.dtype == torch.float32 and lse.is_contiguous()
            and tuple(lse.shape) == (b, h, s) and lse.device == q.device):
        raise ValueError(
            f"flash_attention's backward kernel takes bf16 with D a "
            f"multiple of 16 and a float32 (B, H, S) lse; got {q.dtype}, "
            f"D={d}, lse {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib_bwd().flash_attention_bwd_launch(
            *(x.data_ptr() for x in (q, k, v, o, do, lse, dq, dk, dv,
                                     delta)),
            b, s, t, h, kvh, d, int(causal), int(window), _sqrt_d(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    BWD_LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
