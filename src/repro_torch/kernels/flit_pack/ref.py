"""Plain PyTorch version of the flit-pack kernel: elementwise evaluation.

The counterpart of ``repro/kernels/flit_pack/ref.py::flit_pack_ref``, op for
op: int32 ceil division and wire bytes, then float32 ``1 + ppm * K`` and
``payload / max(wire * scale, 1)``, each PyTorch operation rounding once.
``K`` is the float32 value of ``1.0 / PPM``, the constant the reference's
weakly typed ``1.0 / PPM`` becomes in float32.  The CPU path and the tests
use it; on the card it is the yardstick the kernel is held against,
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

PPM = 1_000_000
K_PPM = float(np.float32(1.0 / PPM))


def flit_pack_ref(payload, flit_size, flit_payload, replay_ppm):
    """Wire bytes + goodput efficiency of each packet (elementwise).

    payload       (K,) int32 logical TLP bytes per packet
    flit_size     (K,) int32 flit wire bytes; 0 = byte-exact channel
    flit_payload  (K,) int32 TLP bytes per flit
    replay_ppm    (K,) int32 expected extra CRC-replay transmissions (ppm)

    Returns (wire_bytes int32, efficiency float32).
    """
    pay = payload.int()
    fsize = flit_size.int()
    fpay = torch.clamp_min(flit_payload.int(), 1)
    n_flits = (pay + fpay - 1) // fpay
    wire = torch.where(fsize > 0, n_flits * fsize, pay)
    scale = 1.0 + replay_ppm.int().float() * K_PPM
    eff = pay.float() / torch.clamp_min(wire.float() * scale, 1.0)
    return wire, eff
