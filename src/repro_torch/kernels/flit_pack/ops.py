"""Public flit-efficiency ops: mode/BER handling + whole-sweep dispatch.

The counterpart of ``repro/kernels/flit_pack/ops.py``: ``flit_pack``
evaluates one array of packets under one link config; ``flit_sweep`` builds
the flit-mode x BER cross product the link-layer studies plot, flattens it
into one kernel call and takes each cell's mean with ``torch.mean`` outside
the kernel (as the reference's ``jnp.mean`` is outside its kernel).

Both run on ``device`` (the card by default; a machine without one raises
unless the caller passes ``device="cpu"``).  The tensors' device picks the
path: the CUDA kernel (`kernel.flit_pack_kernel`) on the card, the plain
version (`ref.flit_pack_ref`) on the CPU; on the card nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import link_layer
from ...core.engine import resolve_device, to_host
from .kernel import flit_pack_kernel
from .ref import flit_pack_ref

# Largest payload whose wire bytes (ceil(p/236)*256, the worst expansion
# ratio) still fit the kernel's int32 arithmetic; larger inputs would wrap
# silently, so the public entry points reject them.
MAX_PAYLOAD_B = 1_900_000_000


def _check_payload(payload_bytes) -> None:
    arr = to_host(payload_bytes)
    if arr.size and int(arr.max()) > MAX_PAYLOAD_B:
        raise ValueError(
            f"payload {int(arr.max())} B exceeds MAX_PAYLOAD_B "
            f"({MAX_PAYLOAD_B}); wire bytes would overflow the kernel's "
            "int32 arithmetic")


def _payload(payload_bytes, device) -> torch.Tensor:
    _check_payload(payload_bytes)
    dev = resolve_device(device)
    if isinstance(payload_bytes, torch.Tensor):
        return payload_bytes.to(device=dev, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.asarray(payload_bytes).astype(np.int32)).to(
        dev)


def _dispatch(payload, fsize, fpay, ppm):
    if payload.is_cuda:
        return flit_pack_kernel(payload, fsize, fpay, ppm)
    return flit_pack_ref(payload, fsize, fpay, ppm)


def flit_pack(payload_bytes, mode: str = "flit256", ber: float = 0.0,
              retry_window: int = 16, *, device="cuda"):
    """(wire_bytes int32, goodput_efficiency float32) of packets under one
    link config."""
    pay = _payload(payload_bytes, device)
    size, fp = link_layer.FLIT_GEOMETRY[mode]
    ppm = link_layer.replay_overhead_ppm(ber, mode, retry_window)
    return _dispatch(pay, torch.full_like(pay, size), torch.full_like(pay, fp),
                     torch.full_like(pay, ppm))


def flit_sweep(payload_bytes, modes, bers, retry_window: int = 16, *,
               device="cuda"):
    """Mean goodput efficiency over a flit-mode x BER grid, in one kernel
    call.

    payload_bytes: (K,) packet sizes (e.g. a workload's payload histogram).
    Returns (M, B) float32 — rows follow ``modes``, columns follow ``bers``.
    """
    pay = _payload(payload_bytes, device)
    k = pay.shape[0]
    m, b = len(modes), len(bers)
    size = np.empty((m, b), np.int32)
    fp = np.empty((m, b), np.int32)
    ppm = np.empty((m, b), np.int32)
    for i, mode in enumerate(modes):
        size[i, :], fp[i, :] = link_layer.FLIT_GEOMETRY[mode]
        for j, ber in enumerate(bers):
            ppm[i, j] = link_layer.replay_overhead_ppm(ber, mode,
                                                       retry_window)

    def tile(a):
        return torch.from_numpy(a.reshape(-1)).to(pay.device) \
            .repeat_interleave(k)

    _, eff = _dispatch(pay.repeat(m * b), tile(size), tile(fp), tile(ppm))
    return torch.mean(eff.view(m * b, k), dim=1).view(m, b)
