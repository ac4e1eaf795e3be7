"""Public entry point of the RG-LRU scan: device dispatch and gradient.

``rglru_scan(a, b)`` is the counterpart of
``repro/kernels/rglru_scan/ops.py::rglru_scan``: ``h_t = a_t * h_{t-1} +
b_t`` over the sequence axis of (B, S, D) tensors, in float32.  The tensors'
device picks the path: the CUDA kernel (`kernel.rglru_scan_kernel`) when they
lie on the card, the plain version (`ref.rglru_scan_ref`) when they lie on
the CPU.  On the card it launches the kernel or raises; nothing falls back.

With grad enabled and ``a`` or ``b`` requiring it, the call is a
`torch.autograd.Function` (`RGLRUScan`): its backward is the same scan in
reverse (`kernel.rglru_scan_kernel(..., reverse=True)` on the card,
`ref.rglru_scan_bwd_plain` on the CPU) giving the adjoint ``lam``, then
``db = lam`` and ``da_t = lam_t h_{t-1}`` elementwise.  The reference
defines no VJP: it differentiates its associative scan by autodiff, which
computes the same derivatives.
"""

from __future__ import annotations

import torch

from .kernel import rglru_scan_kernel
from .ref import rglru_scan_bwd_plain, rglru_scan_ref


def _forward(a, b):
    if a.is_cuda:
        return rglru_scan_kernel(a, b)
    return rglru_scan_ref(a, b)


class RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = _forward(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        g = g.to(h.dtype).contiguous()
        lam = rglru_scan_kernel(a, g, reverse=True) if a.is_cuda \
            else rglru_scan_bwd_plain(a, g)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
        return lam * h_prev, lam


def rglru_scan(a, b):
    """a, b: (B, S, D) -> h: (B, S, D) float32, on the device of the
    inputs; differentiable in a and b."""
    a = a.float().contiguous()
    b = b.float().contiguous()
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RGLRUScan.apply(a, b)
    return _forward(a, b)
