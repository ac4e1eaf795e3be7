"""The backward pass of the tensor-core SSD chunk scan — the wrapper of its
Hopper CUDA kernels.

Replaces nothing on the TPU: the JAX package defines no gradient for its
Pallas kernel (``repro/kernels/ssd_chunk/kernel.py::ssd_chunk_pallas``) and
trains an ``ssd`` layer by autodiff through its plain ``ssd_chunked``.  The
port trains through its forward kernel (`kernel.ssd_chunk_kernel`, which
writes each chunk's incoming state on request), and these kernels give that
forward its gradient: ``csrc/ssd_chunk_bwd.cu``, CUDA C++ for ``sm_90a``
(``wgmma`` fed by TMA, through ``kernels/_hopper.cuh``), built with ``nvcc``
at first use (`kernels._build`) and called through ``ctypes`` on PyTorch's
current stream.  Three launches a call after a memset of the walk's status
words: the adjoint walk (a block per (batch row, head, segment of chunks),
`walk_segments` segments a head, from the last chunk: each chunk's
adjoint R out in float32), the chunk gradients (a block per
(batch row, chunk, group of `head_group` heads): dx, and dB and dC summed
over the group's heads on chip), then the ordered sums (the groups'
partials of dB and dC, d cs's reverse cumsum, ddt and da_log); counted once
in ``BWD_LAUNCHES["ssd_chunk_bwd"]``.  It takes bf16 x, b, c and dy with P
and N multiples of 8, the types the models train in.  Its plain version is
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

from .kernel import CHUNK, MAX_N, MAX_P, SMS, _load, uses_tensor_cores

_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk_bwd.cu"

# heads a block of the gradient launch sums dB and dC over, at most
# (``GMAX`` in the CUDA source)
GROUP_MAX = 8

# launches of the backward kernels (one a call of its three), counted by
# the wrapper (a run resets it to 0 and reads it back)
BWD_LAUNCHES = {"ssd_chunk_bwd": 0}


def _lib_bwd():
    lib = _load(_SOURCE, "ssd_chunk_bwd", 14, 7)
    launch = lib.ssd_chunk_bwd_launch
    if len(launch.argtypes) == 14 + 7 + 1:
        # and the events the call records between its launches, or null
        launch.argtypes = launch.argtypes + [ctypes.c_void_p]
        lib.ssd_chunk_bwd_workspace.argtypes = [ctypes.c_int] * 7
        lib.ssd_chunk_bwd_workspace.restype = ctypes.c_longlong
        for name in ("smem", "walk_smem", "max_group"):
            fn = getattr(lib, f"ssd_chunk_bwd_{name}")
            fn.argtypes = []
            fn.restype = ctypes.c_int
        if lib.ssd_chunk_bwd_max_group() != GROUP_MAX:
            raise RuntimeError(f"{_SOURCE.name} takes groups of "
                               f"{lib.ssd_chunk_bwd_max_group()} heads, the "
                               f"wrapper {GROUP_MAX}")
    return lib


def walk_segments(bsz: int, h: int, s: int) -> int:
    """Segments a head for the adjoint walk at batch ``bsz``, ``h`` heads
    and ``s`` steps: as many as half a wave of blocks holds (66 units on
    the card's `SMS`), at most one a chunk, at least one.  The walk moves
    dY, S and R once and runs near the memory's rate on half the card, so
    a second segment (a pass 1 and a hand-off) buys nothing there: 1 at
    mamba2-1.3b's B 1, H 64, where `chip_smoke.py`'s ``ms_by_segments``
    times 1, 2 and 4."""
    n_chunks = -(-s // CHUNK)
    return max(1, min(n_chunks, (SMS // 2) // (bsz * h)))


def head_group(bsz: int, h: int, s: int) -> int:
    """Heads a block of the gradient launch takes at batch ``bsz``, ``h``
    heads and ``s`` steps: `GROUP_MAX`, halved while the blocks (batch rows
    x chunks x groups) would not fill the card's `SMS` once, at least one.
    dB's and dC's partials shrink by the group size; 8 at mamba2-1.3b's
    B 1, H 64 from 17 chunks (2,049 tokens; 256 blocks at 4,096), where
    `chip_smoke.py`'s ``ms_by_group`` times 2, 4 and 8."""
    n_chunks = -(-s // CHUNK)
    g = min(GROUP_MAX, h)
    while g > 1 and bsz * n_chunks * -(-h // g) < SMS:
        g = (g + 1) // 2
    return g


def ssd_chunk_bwd_kernel(x, dt, a_log, b, c, dy, dstate, states, *,
                         segments: int | None = None,
                         group: int | None = None, marks=None):
    """The gradient of `kernel.ssd_chunk_kernel` (bf16, P and N multiples of
    8): x and dy (B, S, H, P), b and c (B, S, N), contiguous bf16 CUDA
    tensors; dt (B, S, H) and a_log (H,) float32; ``dstate`` (B, H, P, N)
    float32, the final state's adjoint, or None (zero); ``states`` (B, H,
    chunks, P, N) float32, the forward's chunk states (``return_states``) ->
    (dx bf16, ddt, da_log, db, dc float32) in the inputs' layouts.  Launches
    on the current stream (one count); raises on any tensor it does not
    take or on a failed launch.  ``segments``: the walk's segments a head
    (at most one a chunk), by default `walk_segments`; ``group``:
    heads a gradient block (1 to `GROUP_MAX`), by default `head_group`;
    both for tests and timing.  ``marks``: four ``torch.cuda.Event`` s,
    each recorded once already, that the call records before its first
    launch and after each of the three, to time them."""
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
    seg = walk_segments(bsz, h, s) if segments is None else max(
        1, min(int(segments), n_chunks))
    grp = head_group(bsz, h, s) if group is None else max(
        1, min(int(group), GROUP_MAX))
    with torch.cuda.device(x.device):
        lib = _lib_bwd()
        ws = torch.empty(lib.ssd_chunk_bwd_workspace(bsz, s, h, p, n, seg,
                                                     grp),
                         dtype=torch.uint8, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        events = None if marks is None else (ctypes.c_void_p * 4)(
            *(e.cuda_event for e in marks))
        err = lib.ssd_chunk_bwd_launch(
            *(t.data_ptr() for t in (x, dt, a_log, b, c, dy, states)),
            None if dstate is None else dstate.data_ptr(),
            *(t.data_ptr() for t in (dx, ddt, da, db, dc, ws)),
            bsz, s, h, p, n, seg, grp, stream, events)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd kernel launch failed: CUDA error "
                           f"{err}")
    BWD_LAUNCHES["ssd_chunk_bwd"] += 1
    return dx, ddt, da, db, dc
