"""Public entry point of the SSD chunk scan: device dispatch.

``ssd_chunk(x, dt, a_log, b, c, chunk=)`` is the counterpart of
``repro/kernels/ssd_chunk/ops.py::ssd_chunk`` (the Mamba-2 SSD over chunks)
that also returns the recurrent state after the last step, which the
reference's prefill computes in a second pass (``models/ssd.py::
_final_state``).  The tensors' device picks the path: the CUDA kernels
(`kernel.ssd_chunk_kernel`, the tensor-core one for bf16) when they lie on
the card, the plain versions
(`ref.ssd_chunk_ref`, `ref.ssd_final_state`) when they lie on the CPU.  On
the card it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import torch

from .kernel import CHUNK, ssd_chunk_kernel
from .ref import ssd_chunk_ref, ssd_final_state


def ssd_chunk(x, dt, a_log, b, c, *, chunk: int = 128):
    """x: (B, S, H, P); dt: (B, S, H); a_log: (H,); b, c: (B, S, N) ->
    (y (B, S, H, P) in x's dtype, final state (B, H, P, N) float32).  x, b
    and c go to the kernel in their dtype when all three are bf16, else in
    float32."""
    dt = dt.float().contiguous()
    a_log = a_log.float().contiguous()
    if x.is_cuda:
        if chunk != CHUNK:
            raise ValueError(f"the CUDA kernel scans chunks of {CHUNK} "
                             f"steps, not {chunk}")
        dtype = torch.bfloat16 if x.dtype == b.dtype == c.dtype == \
            torch.bfloat16 else torch.float32
        y, state = ssd_chunk_kernel(
            x.to(dtype).contiguous(), dt, a_log, b.to(dtype).contiguous(),
            c.to(dtype).contiguous())
        return y.to(x.dtype), state
    return (ssd_chunk_ref(x, dt, a_log, b, c, chunk=chunk),
            ssd_final_state(x, dt, a_log, b, chunk=chunk))
