"""Public entry point of the SSD chunk scan: device dispatch and gradient.

``ssd_chunk(x, dt, a_log, b, c, chunk=)`` is the counterpart of
``repro/kernels/ssd_chunk/ops.py::ssd_chunk`` (the Mamba-2 SSD over chunks)
that also returns the recurrent state after the last step, which the
reference's prefill computes in a second pass (``models/ssd.py::
_final_state``).  The tensors' device picks the path: the CUDA kernels
(`kernel.ssd_chunk_kernel`, the tensor-core one for bf16) when they lie on
the card, the plain versions
(`ref.ssd_chunk_ref`, `ref.ssd_final_state`) when they lie on the CPU.  On
the card it launches the kernel or raises; nothing falls back.

With grad enabled and an input requiring it, the call is a
`torch.autograd.Function` (`SSDChunk`), differentiable in x, dt, a_log, b
and c through both outputs: on the card the forward kernel also writes each
chunk's incoming state and the backward is
`kernel_bwd.ssd_chunk_bwd_kernel` (bf16 with P and N multiples of 8, the
types the models train in; float32 or another shape raises
``NotImplementedError``, since only the tensor-core kernel writes the chunk
states); on the CPU the forward is the plain version and the backward
`ref.ssd_chunk_bwd_plain`, so that the CPU tests run the backward
algorithm.  Tensors are kept for the backward only through
``save_for_backward``, so that the trainer's non-reentrant checkpoint drops
them and recomputes the forward.  The reference defines no gradient for its
kernel and differentiates its plain ``ssd_chunked``; calls without grad,
every serving call, are unchanged.
"""

from __future__ import annotations

import torch

from .kernel import CHUNK, ssd_chunk_kernel, uses_tensor_cores
from .kernel_bwd import ssd_chunk_bwd_kernel
from .ref import ssd_chunk_bwd_plain, ssd_chunk_ref, ssd_final_state


class SSDChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        if x.is_cuda:
            y, state, states = ssd_chunk_kernel(x, dt, a_log, b, c,
                                                return_states=True)
            ctx.save_for_backward(x, dt, a_log, b, c, states)
        else:
            y = ssd_chunk_ref(x, dt, a_log, b, c, chunk=chunk)
            state = ssd_final_state(x, dt, a_log, b, chunk=chunk)
            ctx.save_for_backward(x, dt, a_log, b, c)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a_log, b, c, *states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype)
        if x.is_cuda:
            dstate = None if dstate is None else dstate.float().contiguous()
            grads = ssd_chunk_bwd_kernel(x, dt, a_log, b, c, dy.contiguous(),
                                         dstate, states[0])
        else:
            grads = ssd_chunk_bwd_plain(x, dt, a_log, b, c, dy, dstate,
                                        chunk=ctx.chunk)
        dx, ddt, da, db, dc = grads
        return (dx.to(x.dtype), ddt.to(dt.dtype), da.to(a_log.dtype),
                db.to(b.dtype), dc.to(c.dtype), None)


def ssd_chunk(x, dt, a_log, b, c, *, chunk: int = 128):
    """x: (B, S, H, P); dt: (B, S, H); a_log: (H,); b, c: (B, S, N) ->
    (y (B, S, H, P) in x's dtype, final state (B, H, P, N) float32);
    differentiable in all five inputs.  x, b and c go to the kernel in
    their dtype when all three are bf16, else in float32; on the CPU a
    float64 x computes in float64."""
    ct = torch.float64 if not x.is_cuda and x.dtype == torch.float64 \
        else torch.float32
    dt = dt.to(ct).contiguous()
    a_log = a_log.to(ct).contiguous()
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, a_log, b, c))
    out_dtype = x.dtype
    if x.is_cuda:
        if chunk != CHUNK:
            raise ValueError(f"the CUDA kernel scans chunks of {CHUNK} "
                             f"steps, not {chunk}")
        dtype = torch.bfloat16 if x.dtype == b.dtype == c.dtype == \
            torch.bfloat16 else torch.float32
        if grad and not uses_tensor_cores(dtype, x.shape[-1], b.shape[-1]):
            raise NotImplementedError(
                f"ssd_chunk's gradient on the card takes bf16 x, b and c "
                f"with P and N multiples of 8 (the tensor-core kernels); got "
                f"{x.dtype}, P={x.shape[-1]}, N={b.shape[-1]}")
        x, b, c = (t.to(dtype).contiguous() for t in (x, b, c))
    if grad:
        y, state = SSDChunk.apply(x, dt, a_log, b, c, chunk)
    elif x.is_cuda:
        y, state = ssd_chunk_kernel(x, dt, a_log, b, c)
    else:
        return (ssd_chunk_ref(x, dt, a_log, b, c, chunk=chunk),
                ssd_final_state(x, dt, a_log, b, chunk=chunk))
    return y.to(out_dtype), state
