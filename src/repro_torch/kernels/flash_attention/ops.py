"""Public entry point of flash attention: model layout, device dispatch,
gradient.

``flash_attention(q, k, v, causal=, window=)`` is the counterpart of
``repro/kernels/flash_attention/ops.py::flash_attention``: q (B, S, H, D),
k and v (B, T, KV, D) -> (B, S, H, D), the query heads grouped per KV head
without replicating K and V.  ``window`` 0 means no window.

The tensors' device picks the path: the CUDA kernels
(`kernel.flash_attention_kernel`, which reads the model layout itself and
takes the tensor-core kernel for bf16) when they lie on the card, the plain
version (`ref.flash_attention_ref`) when they lie on the CPU.  On the card
it launches the kernel or raises; nothing falls back.  Both paths take S <=
T, so that every query row sees at least one key.

With grad enabled and an input requiring it, the call is a
`torch.autograd.Function` (`FlashAttention`): its forward also keeps the
rows' base-2 log-sum-exp, its backward is
`kernel_bwd.flash_attention_bwd_kernel` on the card (bf16, the type the
models train in; float32 raises, since only the tensor-core kernel writes
the log-sum-exp) and `ref.flash_attention_bwd_plain` on the CPU, so that
the CPU tests run the backward algorithm.  On the card a head dim that is
not a multiple of 16 (the smoke configs' 8 and 12) is padded with zero
columns to the next one (`padded_head_dim`) for both tensor-core kernels,
which divide the scores by the true D's square root; the zero columns add
nothing to any score, and their outputs and gradients are sliced off.  The
reference defines no VJP for its kernel and trains through its plain
attention; calls without grad, every serving call, are unchanged (bf16 at
D 8 or 12 keeps the CUDA-core kernel there).
"""

from __future__ import annotations

import torch

from .kernel import _sqrt_d, flash_attention_kernel, uses_tensor_cores
from .kernel_bwd import flash_attention_bwd_kernel
from .ref import flash_attention_bwd_plain, flash_attention_ref


def padded_head_dim(d: int) -> int:
    """The head dim the tensor-core kernels run a bf16 call of head dim
    ``d`` at under autograd: ``d`` rounded up to a multiple of 16."""
    return -(-d // 16) * 16


def pad_head_dim(x, dp: int):
    """``x`` (..., D) with zero columns appended up to ``dp``."""
    d = x.shape[-1]
    return x if dp == d else torch.nn.functional.pad(x, (0, dp - d))


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        d = q.shape[-1]
        ctx.mask = dict(causal=causal, window=window)
        if q.is_cuda:
            dp = padded_head_dim(d)
            if not uses_tensor_cores(q.dtype, dp):
                raise NotImplementedError(
                    f"flash_attention's gradient on the card takes bf16 (the "
                    f"tensor-core kernels); got {q.dtype}, D={d}")
            q, k, v = (pad_head_dim(x, dp) for x in (q, k, v))
            ctx.kernel = dict(ctx.mask, sqrt_d=_sqrt_d(d))
            out, lse = flash_attention_kernel(q, k, v, return_lse=True,
                                              **ctx.kernel)
        else:
            out, lse = flash_attention_ref(q, k, v, return_lse=True,
                                           **ctx.mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.d = d
        return out if out.shape[-1] == d else out[..., :d].contiguous()

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_cuda:
            do = pad_head_dim(do.to(q.dtype), q.shape[-1]).contiguous()
            grads = flash_attention_bwd_kernel(q, k, v, out, do, lse,
                                               **ctx.kernel)
        else:
            grads = flash_attention_bwd_plain(q, k, v, out, do, lse,
                                              **ctx.mask)
        dq, dk, dv = (g[..., :ctx.d].to(x.dtype)
                      for g, x in zip(grads, (q, k, v)))
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
