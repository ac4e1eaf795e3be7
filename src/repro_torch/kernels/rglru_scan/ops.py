"""Public entry point of the RG-LRU scan: device dispatch.

``rglru_scan(a, b)`` is the counterpart of
``repro/kernels/rglru_scan/ops.py::rglru_scan``: ``h_t = a_t * h_{t-1} +
b_t`` over the sequence axis of (B, S, D) tensors, in float32.  The tensors'
device picks the path: the CUDA kernel (`kernel.rglru_scan_kernel`) when they
lie on the card, the plain version (`ref.rglru_scan_ref`) when they lie on
the CPU.  On the card it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

from .kernel import rglru_scan_kernel
from .ref import rglru_scan_ref


def rglru_scan(a, b):
    """a, b: (B, S, D) -> h: (B, S, D) float32, on the device of the
    inputs."""
    a = a.float().contiguous()
    b = b.float().contiguous()
    if a.is_cuda:
        return rglru_scan_kernel(a, b)
    return rglru_scan_ref(a, b)
