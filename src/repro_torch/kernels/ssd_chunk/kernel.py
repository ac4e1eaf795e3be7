"""Mamba-2 SSD chunk scan — the wrapper of its two Hopper CUDA kernels.

Replaces ``repro/kernels/ssd_chunk/kernel.py::ssd_chunk_pallas`` (the
Pallas TPU kernel, ``pl.pallas_call`` at its line 82).  Both kernels are
CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use
(`kernels._build`) and called through ``ctypes`` on PyTorch's current
stream.  The wrapper picks one by dtype and shape:

* bf16 x, b and c with P and N multiples of 8 (the served model's case):
  ``csrc/ssd_chunk_tc.cu``, one launch (after one memset of its status
  words): a block per (batch row, head, segment of chunks), `segment_count`
  segments a head, ``wgmma`` fed by TMA, the running (P, N) state kept in
  registers from chunk to chunk and handed from segment to segment through
  a small workspace in a fixed chain; every float32 operand split into
  three bf16 parts against exact bf16 ones; counted in
  ``LAUNCHES["ssd_chunk_tc"]``.  On request (``return_states``, the
  training path) it also writes each chunk's incoming state, which the
  backward kernel (`kernel_bwd.ssd_chunk_bwd_kernel`) reads;
* float32 inputs, or bf16 of another shape: ``csrc/ssd_chunk.cu``, float32
  FMA on the CUDA cores, three phases (chunk states, a walk over the chunks,
  chunk outputs); counted in ``LAUNCHES["ssd_chunk"]``.

Nothing falls back from one to the other.  The gradient of the
tensor-core kernel is a kernel of its own (`kernel_bwd.ssd_chunk_bwd_kernel`,
``csrc/ssd_chunk_bwd.cu``); `ops.ssd_chunk` is the autograd op over both.

What they compute: `ref.ssd_chunk_ref` (the SSD output y) and
`ref.ssd_final_state` (the recurrent state after the last step) in one
call, up to the order of the float32 sums, over chunks of ``chunk`` steps,
one of `CHUNKS` (the tail chunk masked).  `ref.ssd_chunk_segmented` runs
the tensor-core kernel's decomposition and roundings on the CPU,
`ref.ssd_chunk_blocked` the CUDA-core kernel's.  Any S is taken; P and N
up to `MAX_P` and `MAX_N`.

Bound on the H100: memory.  One layer's prefill of mamba2-1.3b at S = 4096
moves 72.4 MB (x and y in bf16, b, c, dt and the final state) against 12.9
GFLOP of minimal work.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import load_library

_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"
_SOURCE_TC = _SOURCE.with_name("ssd_chunk_tc.cu")

# the chunk lengths the kernels have an instance for, and their largest head
# dim and state size (``CHUNKS``, ``MAX_P`` and ``MAX_N`` in the CUDA
# sources, which the libraries report back when they are loaded)
CHUNKS = (32, 64, 128, 256)
MAX_P = 64
MAX_N = 128

# streaming multiprocessors of the H100 (SXM), which `segment_count` fills
# once
SMS = 132

# launches of each CUDA kernel, counted by the wrapper (a run resets them to
# 0 and reads them back to show that its path went through the kernels)
LAUNCHES = {"ssd_chunk": 0, "ssd_chunk_tc": 0}


def built_chunks(lib, prefix: str) -> tuple:
    """The chunk lengths a loaded library has instances for, as it reports
    them (``<prefix>_chunks``)."""
    fn = getattr(lib, f"{prefix}_chunks")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    return tuple(out[:min(fn(out, 8), 8)])


def _load(source, prefix: str, n_ptrs: int, n_ints: int):
    lib = load_library(source)
    launch = getattr(lib, f"{prefix}_launch")
    if launch.argtypes is None:
        launch.argtypes = [ctypes.c_void_p] * n_ptrs + [
            ctypes.c_int] * n_ints + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        sizes = [getattr(lib, f"{prefix}_{x}") for x in ("max_p", "max_n")]
        for fn in sizes:
            fn.argtypes = []
            fn.restype = ctypes.c_int
        built = (built_chunks(lib, prefix),) + tuple(fn() for fn in sizes)
        if built != (CHUNKS, MAX_P, MAX_N):
            raise RuntimeError(
                f"{source.name} has (chunks, max P, max N) = {built}, the "
                f"wrapper {(CHUNKS, MAX_P, MAX_N)}")
    return lib


def check_chunk(chunk: int) -> int:
    """``chunk`` if the CUDA kernels have an instance for it (`CHUNKS`), else
    ``ValueError``.  The reference takes any chunk length that divides S;
    the card takes these four."""
    if chunk not in CHUNKS:
        raise ValueError(f"the CUDA kernels scan chunks of {CHUNKS} steps, "
                         f"not {chunk}")
    return int(chunk)


def _lib():
    return _load(_SOURCE, "ssd_chunk", 9, 7)


def _lib_tc():
    lib = _load(_SOURCE_TC, "ssd_chunk_tc", 9, 7)
    lib.ssd_chunk_tc_workspace.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int]
    lib.ssd_chunk_tc_workspace.restype = ctypes.c_longlong
    lib.ssd_chunk_tc_smem.argtypes = [ctypes.c_int]
    lib.ssd_chunk_tc_smem.restype = ctypes.c_int
    return lib


def segment_count(bsz: int, h: int, s: int, chunk: int = 128) -> int:
    """Segments a head for the tensor-core kernel at batch ``bsz``, ``h``
    heads, ``s`` steps and chunks of ``chunk``: as many as one wave of
    blocks holds (a block takes an SM: 217 KB of shared memory at every
    chunk length), at most one a chunk, at least one.  So 1 where the
    sequence is one chunk or the B * H units alone fill the card's `SMS`,
    and 2 at mamba2-1.3b's B 1, H 64 for any S past one chunk.  A second
    wave waits for the first, and every segment but a head's last runs a
    pass over its chunks of its own, so the fewest
    segments that fill the card once take the least time (`chip_smoke.py`'s
    ``kernel_timing`` line for ``ssd_chunk_tc`` times 1, 2 and 4 segments
    at B 1, H 64, S 4,096)."""
    n_chunks = -(-s // chunk)
    return max(1, min(n_chunks, SMS // (bsz * h)))


def uses_tensor_cores(dtype, p: int, n: int) -> bool:
    """Whether a call with x, b and c of this dtype, head dim ``p`` and
    state size ``n`` takes the tensor-core kernel (else the CUDA-core
    one)."""
    return dtype == torch.bfloat16 and p % 8 == 0 and n % 8 == 0


def ssd_chunk_kernel(x, dt, a_log, b, c, *, chunk: int = 128,
                     segments: int | None = None,
                     return_states: bool = False):
    """x (B, S, H, P), b and c (B, S, N), all float32 or all bf16; dt
    (B, S, H) and a_log (H,) float32; contiguous CUDA tensors on one
    device; ``chunk`` one of `CHUNKS`.  Returns (y (B, S, H, P) in x's
    dtype, final state (B, H, P, N) float32).  Launches the tensor-core
    kernel for bf16 with P and N multiples of 8, the CUDA-core kernel
    otherwise (`uses_tensor_cores`),
    on the current stream; raises on any tensor it does not take or on a
    failed launch.  ``segments`` sets the tensor-core kernel's segments a
    head (at most one a chunk), for tests and timing; by default
    `segment_count` of the shape.  ``return_states`` (the tensor-core
    kernel only) also returns each chunk's incoming state, (B, H, chunks, P,
    N) float32, as a third value."""
    chunk = check_chunk(chunk)
    ok = (x.dim() == 4 and b.dim() == 3 and c.shape == b.shape
          and b.shape[:2] == x.shape[:2] and dt.shape == x.shape[:3]
          and a_log.shape == x.shape[2:3]
          and x.dtype in (torch.float32, torch.bfloat16)
          and b.dtype == c.dtype == x.dtype
          and dt.dtype == a_log.dtype == torch.float32)
    for t in (x, dt, a_log, b, c):
        ok = ok and t.is_cuda and t.is_contiguous() and t.device == x.device
    if not ok:
        raise ValueError(
            "ssd_chunk takes contiguous CUDA tensors on one device: x (B, S, "
            "H, P), b and c (B, S, N) of one dtype (float32 or bf16), dt "
            "(B, S, H) and a_log (H,) float32")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_chunk takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"got P={p}, N={n}")
    tc = uses_tensor_cores(x.dtype, p, n)
    if return_states and not tc:
        raise ValueError("only the tensor-core kernel writes the chunk "
                         "states: bf16 x, b and c with P and N multiples of 8")
    y = torch.empty_like(x)
    n_chunks = -(-s // chunk)
    chunk_in = torch.empty((bsz, h, n_chunks, p, n), dtype=torch.float32,
                           device=x.device) if return_states else None
    if x.numel() == 0 or n == 0:
        state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                            device=x.device)
        if return_states:
            return y, state, chunk_in.zero_()
        return y, state
    # every element is written by the kernel
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), state.data_ptr())
    if tc:
        lib = _lib_tc()
        seg = segment_count(bsz, h, s, chunk) if segments is None else max(
            1, min(int(segments), n_chunks))
        # the unit counter and status words, then an inclusive state a unit
        ws = torch.empty(lib.ssd_chunk_tc_workspace(bsz * h * seg, p, n),
                         dtype=torch.uint8, device=x.device)
    elif n_chunks > 1:
        states = torch.empty((bsz, h, n_chunks, p, n), dtype=torch.float32,
                             device=x.device)
        decay = torch.empty((bsz, h, n_chunks), dtype=torch.float32,
                            device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            err = lib.ssd_chunk_tc_launch(
                *ptrs, ws.data_ptr(),
                None if chunk_in is None else chunk_in.data_ptr(), bsz, s, h,
                p, n, chunk, seg, stream)
        else:
            scratch = ((states.data_ptr(), decay.data_ptr())
                       if n_chunks > 1 else (None, None))
            err = _lib().ssd_chunk_launch(
                *ptrs, *scratch, int(x.dtype == torch.bfloat16), bsz, s, h,
                p, n, chunk, stream)
    name = "ssd_chunk_tc" if tc else "ssd_chunk"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    if return_states:
        return y, state, chunk_in
    return y, state
