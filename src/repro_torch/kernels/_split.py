"""The split of float32 values into bf16 parts, as the port's tensor-core
kernels take it (``kernels/_mma.cuh::split2``, ``split3``), for their CPU
emulations.

A float32 weight ``w`` that multiplies an exact bf16 operand goes to the
tensor cores as two bf16 operands, ``hi = bf16_rn(w)`` and ``lo =
bf16_rn(w - hi)``, and two products: ``w - hi`` is exact in float32, and
``|w - hi - lo| <= 2^-17 |w|``, where one bf16 rounding would leave 2^-9.
Three parts (``mid = bf16_rn(w - hi)``, ``lo = bf16_rn(w - hi - mid)``) give
back every float32 value of the normal range exactly.
"""

from __future__ import annotations

import torch


def split_bf16(x, parts: int = 2):
    """float32 ``x`` -> ``parts`` float32 tensors holding bf16 values, each
    the bf16 rounding of what the ones before leave: (hi, lo) or (hi, mid,
    lo)."""
    out = []
    for _ in range(parts):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return tuple(out)
