"""Public wrapper: one engine serve round, dispatched by device.

`core.engine._one_round` hands this wrapper the *sorted* per-item tensors of
one fixpoint round (items lexsorted by (channel, arrival, flat index), with
per-channel table gathers and seed gathers already done).  The round — the
lookups of the last serving item before each item in its channel segment,
each item's (max,+) affine map over the channel state ``v = (depart,
down)``, the scan, and the masked outputs — is defined by its plain version
`ref.serve_round_ref` (see `ref` for the four steps).

The tensors' device picks the path: on the card the fused CUDA kernel
(`kernel.serve_round_fused`: five launches from the fifteen operands to the
three outputs, no ``torch.cummax`` and no PyTorch operation per item in
between), on the CPU the plain version.  On the card it launches the kernel
or raises; nothing falls back.

Everything stays int64 with ``NEG = -2**62``, so unlike the JAX wrapper
(int32 rebased to the round's minimum arrival, 2**29 ps span contract) there
is no span limit.  Times are still taken relative to the round's minimum
arrival and the seeds clamped as the reference does — both exact — so the
maps equal the reference's in value.

Returns the engine's masked per-item ``(start, depart, retrain_stall)``
triple in int64 picoseconds; non-serving items pass through at their
arrival with zero stall.
"""

from __future__ import annotations

import torch

from .kernel import serve_round_fused
from .ref import serve_round_ref


def serve_round(chan, serving, marker, arrive, direction, row, ser, turn,
                rhit, rmiss, retrain, sd_dep, sd_dir, sd_row, sd_down):
    """One sorted serve round.  All inputs (K,) on one device: ``chan``
    int64 sorted with invalid items in a trailing dummy segment;
    ``serving``/``marker`` bool item classes; ``arrive``/``ser``/``turn``/
    ``rhit``/``rmiss``/``retrain``/``sd_dep``/``sd_down`` int64 ps;
    ``direction``/``sd_dir`` int8; ``row``/``sd_row`` int32.  ``sd_*`` are the
    per-item gathered channel seed frontiers (cold: 0 / -1 / -2 / 0).
    Returns int64 ``(start, depart, stall)``."""
    args = (chan, serving, marker, arrive, direction, row, ser, turn, rhit,
            rmiss, retrain, sd_dep, sd_dir, sd_row, sd_down)
    if chan.shape[0] == 0:
        return arrive, arrive, torch.zeros_like(arrive)
    if arrive.is_cuda:
        return serve_round_fused(*args)
    return serve_round_ref(*args)
