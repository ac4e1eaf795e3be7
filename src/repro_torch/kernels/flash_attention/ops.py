"""Public entry point of flash attention: model layout, device dispatch,
gradient.

``flash_attention(q, k, v, causal=, window=)`` is the counterpart of
``repro/kernels/flash_attention/ops.py::flash_attention``: q (B, S, H, D),
k and v (B, T, KV, D) -> (B, S, H, D), the query heads grouped per KV head
without replicating K and V.  ``window`` 0 means no window.

The tensors' device picks the path: the CUDA kernels
(`kernel.flash_attention_kernel`, which reads the model layout itself and
takes the tensor-core kernel for bf16) when they lie on the card, the plain version (`ref.flash_attention_ref`) when
they lie on the CPU.  On the card it launches the kernel or raises; nothing
falls back.  Both paths take S <= T, so that every query row sees at least
one key.

With grad enabled and an input requiring it, the call is a
`torch.autograd.Function` (`FlashAttention`): its forward also keeps the
rows' base-2 log-sum-exp, its backward is
`kernel_bwd.flash_attention_bwd_kernel` on the card (bf16 with D a multiple
of 16, the types the models train in; anything else raises, since only the
tensor-core kernel writes the log-sum-exp) and
`ref.flash_attention_bwd_plain` on the CPU, so that the CPU tests run the
backward algorithm.  The reference defines no VJP for its
kernel and trains through its plain attention; calls without grad, every
serving call, are unchanged.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_kernel, uses_tensor_cores
from .kernel_bwd import flash_attention_bwd_kernel
from .ref import flash_attention_bwd_plain, flash_attention_ref


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.is_cuda:
            if not uses_tensor_cores(q.dtype, q.shape[-1]):
                raise NotImplementedError(
                    f"flash_attention's gradient on the card takes bf16 with "
                    f"D a multiple of 16 (the tensor-core kernels); got "
                    f"{q.dtype}, D={q.shape[-1]}")
            out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                              window=window, return_lse=True)
        else:
            out, lse = flash_attention_ref(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_cuda:
            grads = flash_attention_bwd_kernel(
                q, k, v, out, do.to(q.dtype).contiguous(), lse, **ctx.mask)
        else:
            grads = flash_attention_bwd_plain(q, k, v, out, do, lse,
                                              **ctx.mask)
        dq, dk, dv = (g.to(x.dtype) for g, x in zip(grads, (q, k, v)))
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, D); k, v: (B, T, KV, D) -> (B, S, H, D) in q's dtype;
    differentiable in q, k and v."""
    s, t = q.shape[1], k.shape[1]
    if s > t:
        raise ValueError(f"flash_attention takes S <= T, got S={s}, T={t}")
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window)
    if q.is_cuda:
        return flash_attention_kernel(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
