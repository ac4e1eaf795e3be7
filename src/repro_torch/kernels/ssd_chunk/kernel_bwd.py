"""The backward pass of the tensor-core SSD chunk scan — the wrapper of its
Hopper CUDA kernel.

Replaces nothing on the TPU: the JAX package defines no gradient for its
Pallas kernel (``repro/kernels/ssd_chunk/kernel.py::ssd_chunk_pallas``) and
trains an ``ssd`` layer by autodiff through its plain ``ssd_chunked``.  The
port trains through its forward kernel (`kernel.ssd_chunk_kernel`, which
writes each chunk's incoming state on request), and this kernel gives that
forward its gradient: ``csrc/ssd_chunk_bwd.cu``, CUDA C++ for ``sm_90a``
(``mma.sync`` through ``kernels/_mma.cuh``), built with ``nvcc`` at first use
(`kernels._build`) and called through ``ctypes`` on PyTorch's current
stream.  Two launches a call (after a memset of its status words): a block
per (batch row, head, segment of chunks), `kernel.segment_count` segments a
head, walking its chunks from the last (pass 1, the segment's adjoint
aggregate, on every segment but the first; a chained hand-off in reverse;
pass 2, the gradients with the adjoint on chip), then the ordered sum of
the per-head partials of dB, dC and da_log; counted once in
``BWD_LAUNCHES["ssd_chunk_bwd"]``.  It takes bf16 x, b, c and dy with P and
N multiples of 8, the types the models train in.  Its plain version is
`ref.ssd_chunk_bwd_plain`; `ref.ssd_chunk_bwd_segmented` runs its
decomposition and roundings on the CPU.

Bound on the H100: memory, narrowly.  At mamba2-1.3b's layer (B 1, S 4,096,
H 64, P 64, N 128) the call moves 111.1 MB (x, dy and dx and b and c in
bf16; dt, ddt, dstate, db and dc in float32), 0.0332 ms at 3.35 TB/s,
against 30.5 GFLOP of products at one bf16 part each, 0.0308 ms at 989
TFLOP/s; `chip_smoke.py` computes both from each call's shape
(``ssd_bwd_bound_ms``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .kernel import (CHUNK, MAX_N, MAX_P, _load, segment_count,
                     uses_tensor_cores)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk_bwd.cu"

# launches of the backward kernel (one a call of its two), counted by the
# wrapper (a run resets it to 0 and reads it back)
BWD_LAUNCHES = {"ssd_chunk_bwd": 0}


def _lib_bwd():
    lib = _load(_SOURCE, "ssd_chunk_bwd", 14, 6)
    if lib.ssd_chunk_bwd_workspace.argtypes is None:
        lib.ssd_chunk_bwd_workspace.argtypes = [ctypes.c_int] * 6
        lib.ssd_chunk_bwd_workspace.restype = ctypes.c_longlong
        lib.ssd_chunk_bwd_smem.argtypes = []
        lib.ssd_chunk_bwd_smem.restype = ctypes.c_int
    return lib


def ssd_chunk_bwd_kernel(x, dt, a_log, b, c, dy, dstate, states, *,
                         segments: int | None = None):
    """The gradient of `kernel.ssd_chunk_kernel` (bf16, P and N multiples of
    8): x and dy (B, S, H, P), b and c (B, S, N), contiguous bf16 CUDA
    tensors; dt (B, S, H) and a_log (H,) float32; ``dstate`` (B, H, P, N)
    float32, the final state's adjoint, or None (zero); ``states`` (B, H,
    chunks, P, N) float32, the forward's chunk states (``return_states``) ->
    (dx bf16, ddt, da_log, db, dc float32) in the inputs' layouts.  Launches
    on the current stream (one count); raises on any tensor it does not
    take or on a failed launch.  ``segments``: segments a head (at most one
    a chunk), for tests and timing; by default `kernel.segment_count`."""
    ok = (x.dim() == 4 and dy.shape == x.shape and b.dim() == 3
          and c.shape == b.shape and b.shape[:2] == x.shape[:2]
          and dt.shape == x.shape[:3] and a_log.shape == x.shape[2:3]
          and x.dtype == dy.dtype == b.dtype == c.dtype == torch.bfloat16
          and dt.dtype == a_log.dtype == torch.float32)
    if ok:
        bsz, s, h, p = x.shape
        n = b.shape[-1]
        n_chunks = -(-s // CHUNK)
        ok = (uses_tensor_cores(x.dtype, p, n) and p <= MAX_P and n <= MAX_N
              and states.dtype == torch.float32
              and tuple(states.shape) == (bsz, h, n_chunks, p, n)
              and (dstate is None or (dstate.dtype == torch.float32 and
                                      tuple(dstate.shape) == (bsz, h, p, n))))
    tensors = [x, dt, a_log, b, c, dy, states] + (
        [] if dstate is None else [dstate])
    for t in tensors:
        ok = ok and t.is_cuda and t.is_contiguous() and t.device == x.device
    if not ok:
        raise ValueError(
            "ssd_chunk's backward kernel takes contiguous CUDA tensors on one "
            "device: bf16 x and dy (B, S, H, P), b and c (B, S, N) with P <= "
            f"{MAX_P} and N <= {MAX_N} multiples of 8; float32 dt (B, S, H), "
            "a_log (H,), the forward's chunk states (B, H, chunks, P, N) and "
            "dstate (B, H, P, N) or None")
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    da = torch.empty_like(a_log)
    db = torch.empty(b.shape, dtype=torch.float32, device=x.device)
    dc = torch.empty(b.shape, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, ddt.zero_(), da.zero_(), db.zero_(), dc.zero_()
    seg = segment_count(bsz, h, s) if segments is None else max(
        1, min(int(segments), n_chunks))
    with torch.cuda.device(x.device):
        lib = _lib_bwd()
        ws = torch.empty(lib.ssd_chunk_bwd_workspace(bsz, s, h, p, n, seg),
                         dtype=torch.uint8, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_chunk_bwd_launch(
            *(t.data_ptr() for t in (x, dt, a_log, b, c, dy, states)),
            None if dstate is None else dstate.data_ptr(),
            *(t.data_ptr() for t in (dx, ddt, da, db, dc, ws)),
            bsz, s, h, p, n, seg, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd kernel launch failed: CUDA error "
                           f"{err}")
    BWD_LAUNCHES["ssd_chunk_bwd"] += 1
    return dx, ddt, da, db, dc
