"""Segmented (max,+) depart scan — the Hopper CUDA kernel's wrapper.

Replaces ``repro/kernels/link_contention/kernel.py::segmented_depart`` (the
Pallas TPU kernel, ``pl.pallas_call`` at its line 94).  The kernel is CUDA
C++ for ``sm_90a`` in ``csrc/link_contention.cu``, built with ``nvcc`` at
first use (`kernels._build`) and called through ``ctypes`` on PyTorch's
current stream.

What it computes: over a stream sorted by channel, ``depart_i =
max(arrive_i, depart_{i-1} on the same channel) + ser_i`` — exactly
`ref.segmented_depart_ref`, bit for bit.  The TPU kernel carried the running
depart from block to block through scratch memory, relying on its grid
running in order; CUDA blocks have no order, so this one is a single-pass
scan with decoupled look-back over ``(c, m, reset)`` maps: each block takes
the next tile from a counter, scans it, publishes its aggregate (or, when
the tile holds a head, its outgoing depart) and reads its incoming depart
from the tiles before it (`ref.segmented_depart_lookback` runs the same
steps on the CPU).  One launch, plus one memset of the workspace's counter
and status words.  int64 end to end, no rebase, no span limit.

Bound on the H100: memory.  The function reads the channel, arrive and ser
columns and writes depart: 32 B per item with an int64 channel, 28 B with
int32 (about 2.6 µs at K = 268,800 over 3.35 TB/s); the kernel moves each
once.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import load_library

_SOURCE = Path(__file__).resolve().parent / "csrc" / "link_contention.cu"
# workspace: a tile counter, then a status word, the aggregate (c, m) and
# the inclusive depart of every tile (int64 words; csrc/link_contention.cu)
_WORDS_PER_TILE = 4

# launches of the CUDA kernel, counted by the wrapper (a run resets it to 0
# and reads it back to show that its path went through the kernel)
LAUNCHES = {"segmented_depart": 0}


def _lib():
    lib = load_library(_SOURCE)
    if lib.segmented_depart_launch_i64.argtypes is None:
        for fn in (lib.segmented_depart_launch_i64,
                   lib.segmented_depart_launch_i32):
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.segmented_depart_block_items.argtypes = []
        lib.segmented_depart_block_items.restype = ctypes.c_longlong
        lib.segmented_depart_blocks_per_sm.argtypes = []
        lib.segmented_depart_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.cache
def block_items() -> int:
    """Items one CUDA block scans, a tile (set in the CUDA source; builds
    it on the first call)."""
    return int(_lib().segmented_depart_block_items())


def blocks_per_sm() -> int:
    """Blocks of the kernel one SM of the current card holds at once."""
    n = int(_lib().segmented_depart_blocks_per_sm())
    if n <= 0:
        raise RuntimeError("segmented_depart: the occupancy query failed")
    return n


def segmented_depart(chan, arrive, ser):
    """(K,) int64 or int32 channel (sorted), (K,) int64 arrive / ser, all
    contiguous CUDA tensors on one device -> (K,) int64 depart.  Launches
    the CUDA kernel (one single-pass look-back scan) on the current stream;
    raises on any tensor it does not take or on a failed launch."""
    k = chan.shape[0]
    ok = (chan.is_cuda and chan.dim() == 1 and chan.is_contiguous()
          and chan.dtype in (torch.int64, torch.int32))
    for x in (arrive, ser):
        ok = ok and (x.is_cuda and x.dtype == torch.int64 and x.dim() == 1
                     and x.shape[0] == k and x.is_contiguous()
                     and x.device == chan.device)
    if not ok:
        raise ValueError("segmented_depart takes a contiguous 1-D int64 or "
                         "int32 CUDA channel column and two int64 CUDA "
                         "columns of its length on one device")
    out = torch.empty_like(arrive)
    if k == 0:
        return out
    words = 1 + _WORDS_PER_TILE * -(-k // block_items())
    ws = torch.empty(words, dtype=torch.int64, device=chan.device)
    lib = _lib()
    fn = (lib.segmented_depart_launch_i64 if chan.dtype == torch.int64
          else lib.segmented_depart_launch_i32)
    with torch.cuda.device(chan.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(chan.data_ptr(), arrive.data_ptr(), ser.data_ptr(),
                 out.data_ptr(), k, ws.data_ptr(), words, stream)
    if err != 0:
        raise RuntimeError(
            f"segmented_depart kernel launch failed: CUDA error {err}")
    LAUNCHES["segmented_depart"] += 1
    return out
