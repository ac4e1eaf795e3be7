"""Serve round of the schedule engine — the Hopper CUDA kernels' wrappers.

Replaces ``repro/kernels/serve_round/kernel.py::serve_scan`` (the Pallas TPU
kernel, ``pl.pallas_call`` at its line 104) and the pre-pass its JAX wrapper
ran around it.  The kernels are CUDA C++ for ``sm_90a`` in
``csrc/serve_round.cu``, built with ``nvcc`` at first use (`kernels._build`)
and called through ``ctypes`` on PyTorch's current stream.

`serve_round_fused` is the engine's path: from the fifteen sorted operands of
one round (`core.engine._round_inputs`) to the masked ``(start, depart,
stall)`` of every item, equal to `ref.serve_round_ref` bit for bit, in five
launches with no PyTorch operation between them:

  (A) each block's "last present" aggregate (the channel of its last active
      item, the channel and direction of its last serving item, the channel
      and row of its last serving item with a row) and its minimum arrival;
  (B) one block scans those into each block's incoming "last" state and the
      round's base arrival;
  (C) each block builds its items' (max,+) maps from the "last" state before
      each item and composes them into one aggregate map;
  (D) one block scans the aggregate maps into each block's incoming
      ``(depart, down)`` state;
  (E) each block rebuilds its maps, re-scans them from that state and
      writes the three outputs, the finish fused in.

`serve_scan` is the map-only scan (the six map components of
`ref.item_maps` given), in three launches sharing that device code: block
aggregates, one pass over them (D), and a re-scan of each block.  Both
compute ``v' = M_i (x) v (+) c_i`` from ``(NEG, NEG)``, every sum saturated
at ``NEG = -2**62`` (int64 end to end, no span limit); compositions are
regrouped inside a block and across blocks, which is exact on well-formed
maps (see `ref`).  `ref.serve_round_blocked` and `ref.serve_scan_blocked`
run the same decompositions on the CPU.

Bound on the H100: memory.  The fused round must read 84 B of operands and
write 24 B per item, 108 B: 8.7 us at K = 268,800 over 3.35 TB/s.  It moves
about 300 B per item (A reads the 23 B the lookups and the base need, C and
E every operand, and C hands E 44 B per item of thread prefixes) in five
dependent launches of 256-thread blocks of 512 items (the two passes over
the block aggregates one block of 1,024 threads); its time on the card is
in ``PERF.md`` (`chip_smoke.py`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import load_library

_SOURCE = Path(__file__).resolve().parent / "csrc" / "serve_round.cu"

# launches of the CUDA kernels, counted by the wrappers (a run resets them
# to 0 and reads them back to show that its main path went through the
# kernel): the fused round, and the map-only scan
LAUNCHES = {"serve_round": 0, "serve_scan": 0}

# dtypes of the fused round's operands, in `ops.serve_round`'s order
ROUND_DTYPES = (torch.int64, torch.bool, torch.bool, torch.int64, torch.int8,
                torch.int32, torch.int64, torch.int64, torch.int64,
                torch.int64, torch.int64, torch.int64, torch.int8,
                torch.int32, torch.int64)


def _lib():
    lib = load_library(_SOURCE)
    fn = lib.serve_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.serve_scan_block_items.argtypes = []
        lib.serve_scan_block_items.restype = ctypes.c_longlong
        lib.serve_round_launch.argtypes = [ctypes.c_void_p] * 18 + [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        lib.serve_round_launch.restype = ctypes.c_int
        lib.serve_round_scratch_words.argtypes = [ctypes.c_longlong]
        lib.serve_round_scratch_words.restype = ctypes.c_longlong
        lib.serve_round_block_items.argtypes = []
        lib.serve_round_block_items.restype = ctypes.c_longlong
    return lib


def block_items() -> int:
    """Items one CUDA block of the map-only scan covers (set in the CUDA
    source; builds it)."""
    return int(_lib().serve_scan_block_items())


def round_block_items() -> int:
    """Items one CUDA block of the fused round covers (set in the CUDA
    source; builds it)."""
    return int(_lib().serve_round_block_items())


def serve_scan(m00, m01, m10, m11, c0, c1):
    """Six (K,) int64 CUDA map components -> (K,) int64 depart state per
    item.  Launches the CUDA kernel (three phases) on the current stream;
    raises on any tensor it does not take or on a failed launch."""
    maps = (m00, m01, m10, m11, c0, c1)
    k = m00.shape[0]
    for x in maps:
        if not (x.is_cuda and x.dtype == torch.int64 and x.dim() == 1
                and x.shape[0] == k and x.is_contiguous()
                and x.device == m00.device):
            raise ValueError("serve_scan takes six contiguous 1-D int64 "
                             "CUDA tensors of one length on one device")
    out = torch.empty_like(m00)
    if k == 0:
        return out
    n_blocks = -(-k // block_items())
    agg = torch.empty(6 * n_blocks, dtype=torch.int64, device=m00.device)
    state = torch.empty(2 * n_blocks, dtype=torch.int64, device=m00.device)
    with torch.cuda.device(m00.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().serve_scan_launch(
            *(x.data_ptr() for x in maps), out.data_ptr(), k,
            agg.data_ptr(), state.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"serve_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["serve_scan"] += 1
    return out


def serve_round_fused(chan, serving, marker, arrive, direction, row, ser,
                      turn, rhit, rmiss, retrain, sd_dep, sd_dir, sd_row,
                      sd_down):
    """The fifteen (K,) operands of one sorted round (`ops.serve_round`'s
    order and dtypes, contiguous, on one CUDA device, each aligned to two
    items, as every fresh allocation is) -> int64 ``(start, depart,
    stall)``.  Launches the fused CUDA kernel (five phases) on the current
    stream; raises on any tensor it does not take or on a failed launch."""
    args = (chan, serving, marker, arrive, direction, row, ser, turn, rhit,
            rmiss, retrain, sd_dep, sd_dir, sd_row, sd_down)
    k = chan.shape[0]
    dev = chan.device
    for i, (x, dt) in enumerate(zip(args, ROUND_DTYPES)):
        if not (x.is_cuda and x.dtype == dt and x.dim() == 1
                and x.shape[0] == k and x.is_contiguous()
                and x.device == dev
                and x.data_ptr() % (2 * x.element_size()) == 0):
            raise ValueError(f"serve_round operand {i} must be a contiguous "
                             f"1-D {dt} CUDA tensor of length {k} on {dev}, "
                             f"aligned to two items; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    # rows of an even length, so each output is aligned to two items as the
    # kernel's pair stores need
    out = torch.empty((3, k + k % 2), dtype=torch.int64, device=dev)[:, :k]
    if k == 0:
        return out.unbind(0)
    lib = _lib()
    scratch = torch.empty(lib.serve_round_scratch_words(k),
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.serve_round_launch(
            *(x.data_ptr() for x in args), *(o.data_ptr() for o in out), k,
            scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"serve_round kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["serve_round"] += 1
    return out.unbind(0)
