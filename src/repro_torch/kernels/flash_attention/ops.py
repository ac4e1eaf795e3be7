"""Public entry point of flash attention: model layout, device dispatch.

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
"""

from __future__ import annotations

from .kernel import flash_attention_kernel
from .ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, D); k, v: (B, T, KV, D) -> (B, S, H, D) in q's dtype."""
    s, t = q.shape[1], k.shape[1]
    if s > t:
        raise ValueError(f"flash_attention takes S <= T, got S={s}, T={t}")
    if q.is_cuda:
        return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal,
                                      window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
