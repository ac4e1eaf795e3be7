"""Public entry point: per-item departures of one channel-sorted round.

``depart_times(chan, arrive_ps, ser_ps)`` is the counterpart of
``repro/kernels/link_contention/ops.py::depart_times``: over a stream sorted
by channel (within a channel by arrival, as an engine round sorts it),
``depart_i = max(arrive_i, depart_{i-1} on the same channel) + ser_i`` in
int64 picoseconds.  It is the serve round's depart for full-duplex channels
with no turnaround, no DRAM row timing and no link-down markers.

The tensors' device picks the path: the CUDA kernel (`kernel.
segmented_depart`) when they lie on the card, the plain version
(`ref.segmented_depart_ref`) when they lie on the CPU.  On the card it
launches the kernel or raises; nothing falls back.

Unlike the reference, which rebases to the minimum arrival and casts to
int32 (exact only while one round spans less than 2**30 ps), the port stays
int64 end to end: it equals the reference wherever the reference stays
inside int32, and has no span limit.
"""

from __future__ import annotations

import torch

from .kernel import segmented_depart
from .ref import segmented_depart_ref


def depart_times(chan, arrive_ps, ser_ps):
    """chan (K,) sorted int (int64 or int32 kept, other integer types
    widened to int64); arrive / ser (K,) int ps -> depart (K,) int64 ps,
    on the device of the inputs."""
    if chan.dtype not in (torch.int64, torch.int32):
        chan = chan.long()
    chan = chan.contiguous()
    arrive = arrive_ps.long().contiguous()
    ser = ser_ps.long().contiguous()
    if chan.is_cuda:
        return segmented_depart(chan, arrive, ser)
    return segmented_depart_ref(chan, arrive, ser)
