"""Carry lowered state across from the JAX reference, and results back.

This system's counterpart of carrying a model's weights: the reference's
lowered tables — ``Hops`` / ``Channels`` / ``StreamCarry`` / issue times,
given as any object with those fields (numpy or JAX arrays, or tensors) — become the port's tensors on a chosen device, with the
engine's dtypes enforced.  `schedule_to_numpy` goes back.  Only host numpy
is touched here; nothing of the reference is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import (Channels, Hops, Schedule, StreamCarry, resolve_device,
                     to_host)

_HOPS_DTYPES = {
    "channel": np.int32, "nbytes": np.int64, "direction": np.int8,
    "row": np.int32, "fixed_after_ps": np.int64, "is_payload": bool,
    "valid": bool, "extra_wire_bytes": np.int64,
    "retrain_after_ps": np.int64, "join_id": np.int32,
    "join_wait": np.int32, "join_arity": np.int32,
}
_CHANNELS_DTYPES = {name: np.int64 for name in Channels._fields}
_CARRY_DTYPES = {
    "depart_ps": np.int64, "last_dir": np.int8, "last_row": np.int32,
    "down_until_ps": np.int64, "join_seed_ps": np.int64,
}


def _tensor(x, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(to_host(x), dtype=dtype)).to(dev)


def _convert(cls, dtypes, src, device):
    dev = resolve_device(device)
    vals = {}
    for name, dtype in dtypes.items():
        x = getattr(src, name, None)
        vals[name] = None if x is None else _tensor(x, dtype, dev)
    return cls(**vals)


def hops_from_arrays(src, device="cuda") -> Hops:
    """`Hops` on ``device`` from any object with the reference's fields."""
    return _convert(Hops, _HOPS_DTYPES, src, device)


def channels_from_arrays(src, device="cuda") -> Channels:
    """`Channels` on ``device`` from any object with the reference's
    fields."""
    return _convert(Channels, _CHANNELS_DTYPES, src, device)


def carry_from_arrays(src, device="cuda") -> StreamCarry:
    """`StreamCarry` on ``device`` from any object with the reference's
    fields."""
    return _convert(StreamCarry, _CARRY_DTYPES, src, device)


def issue_from_array(x, device="cuda") -> torch.Tensor:
    """(N,) int64 issue times on ``device``."""
    return _tensor(x, np.int64, resolve_device(device))


def schedule_to_numpy(sched: Schedule) -> dict:
    """The schedule as host numpy arrays plus its Python diagnostics."""
    return {
        "arrive": to_host(sched.arrive), "start": to_host(sched.start),
        "depart": to_host(sched.depart), "complete": to_host(sched.complete),
        "rounds": int(sched.rounds), "converged": bool(sched.converged),
        "residual_ps": int(sched.residual_ps),
    }
