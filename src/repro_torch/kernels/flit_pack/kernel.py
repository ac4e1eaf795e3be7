"""Flit packing / goodput efficiency — the Hopper CUDA kernel's wrapper.

Replaces ``repro/kernels/flit_pack/kernel.py::flit_pack_pallas`` (the Pallas
TPU kernel, ``pl.pallas_call`` at its line 59).  The kernel is CUDA C++ for
``sm_90a`` in ``csrc/flit_pack.cu``, built with ``nvcc`` at first use
(`kernels._build`) and called through ``ctypes`` on PyTorch's current
stream.

What it computes, per point: ``n_flits = ceil(payload / flit_payload)``,
``wire = n_flits * flit_size`` (``payload`` on byte-exact points) in int32,
and ``eff = payload / max(wire * (1 + ppm * 1e-6), 1)`` in float32 — exactly
`ref.flit_pack_ref`, bit for bit: every float32 operation is a
round-to-nearest intrinsic, so nothing is fused or approximated.  The TPU
kernel streamed 1024-point blocks through VMEM; this one is a coalesced
grid-stride loop.

Bound on the H100: memory, 24 B per point (four int32 reads, an int32 and a
float32 write).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import load_library

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flit_pack.cu"

# launches of the CUDA kernel, counted by the wrapper (a run resets it to 0
# and reads it back to show that its path went through the kernel)
LAUNCHES = {"flit_pack": 0}


def _lib():
    lib = load_library(_SOURCE)
    fn = lib.flit_pack_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flit_pack_kernel(payload, flit_size, flit_payload, replay_ppm):
    """Four (K,) int32 contiguous CUDA tensors on one device ->
    ``(wire (K,) int32, eff (K,) float32)``.  Launches the CUDA kernel on
    the current stream; raises on any tensor it does not take or on a
    failed launch."""
    cols = (payload, flit_size, flit_payload, replay_ppm)
    k = payload.shape[0]
    for x in cols:
        if not (x.is_cuda and x.dtype == torch.int32 and x.dim() == 1
                and x.shape[0] == k and x.is_contiguous()
                and x.device == payload.device):
            raise ValueError("flit_pack takes four contiguous 1-D int32 CUDA "
                             "tensors of one length on one device")
    wire = torch.empty_like(payload)
    eff = torch.empty(k, dtype=torch.float32, device=payload.device)
    if k == 0:
        return wire, eff
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flit_pack_launch(
            *(x.data_ptr() for x in cols), wire.data_ptr(), eff.data_ptr(),
            k, stream)
    if err != 0:
        raise RuntimeError(f"flit_pack kernel launch failed: CUDA error {err}")
    LAUNCHES["flit_pack"] += 1
    return wire, eff
