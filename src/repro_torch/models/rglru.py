"""RG-LRU recurrence block (RecurrentGemma / Griffin).

The counterpart of ``repro/models/rglru.py``: linear projections, a short
causal temporal conv, and the Real-Gated Linear Recurrent Unit

    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = a^(c * r_t)            with a = sigmoid(Lambda), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence over the prompt through
`kernels.rglru_scan.ops.rglru_scan` (the CUDA kernel on the card, its plain
version on the CPU), where the reference takes ``lax.associative_scan``.
Decode is the O(1) single step. Training (mode ``train``, forward with the
gradient) differentiates the scan through its autograd function: the same
kernel in reverse on the card (`kernels.rglru_scan.ops`). The gate matrices
``w_r`` and ``w_i`` are float32 and multiply float32 activations, as in the
reference; PyTorch keeps TF32 off for matrix products by default, so on the
card they run in full float32. GELU is the tanh approximation,
``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rglru_scan import ops as scan_ops
from .layers import DTYPE, _normal, param

C_EXP = 8.0
CONV_W = 4


class RGLRU(nn.Module):
    def __init__(self, d: int, gen, *, device):
        super().__init__()
        self.w_x = param(_normal(gen, (d, d), d ** -0.5, device=device))
        self.w_gate = param(_normal(gen, (d, d), d ** -0.5, device=device))
        self.conv = param(_normal(gen, (CONV_W, d), 0.1, device=device))
        self.w_r = param(_normal(gen, (d, d), d ** -0.5, torch.float32,
                                 device=device))
        self.w_i = param(_normal(gen, (d, d), d ** -0.5, torch.float32,
                                 device=device))
        # Lambda init so a = sigmoid(L) in ~(0.9, 0.999)
        self.lam = param(torch.linspace(2.2, 6.9, d, dtype=torch.float64)
                         .to(device=device, dtype=torch.float32))
        self.w_o = param(_normal(gen, (d, d), d ** -0.5, device=device))


def rglru_axes():
    return {"w_x": ("embed", "mlp"), "w_gate": ("embed", "mlp"),
            "conv": (None, "mlp"), "w_r": ("embed", "mlp"),
            "w_i": ("embed", "mlp"), "lam": ("mlp",),
            "w_o": ("mlp", "embed")}


def _causal_conv(x, w, state=None):
    """x: (B, S, D); w: (W, D) depthwise causal conv; state: (B, W-1, D).
    The explicit shifted sum of the reference, term by term in x's dtype."""
    b, s, d = x.shape
    if state is None:
        pad = x.new_zeros(b, CONV_W - 1, d)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, CONV_W):
        out = out + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(CONV_W - 1):].clone()
    return out, new_state


def _gates(p: RGLRU, u):
    uf = u.float()
    r = torch.sigmoid(uf @ p.w_r)
    i = torch.sigmoid(uf @ p.w_i)
    log_a = C_EXP * r * F.logsigmoid(p.lam)   # log a_t  (<0)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-8)) \
        * (i * uf)
    return a, b


def rglru_scan(p: RGLRU, u):
    """The recurrence over S.  u: (B, S, D) -> h: (B, S, D) float32."""
    a, b = _gates(p, u)
    return scan_ops.rglru_scan(a, b)


def rglru_block(p: RGLRU, x, *, mode, cache=None):
    """Full recurrent sub-block.  mode: forward | train | prefill |
    decode.
    cache: dict(conv (B, W-1, D) bf16, h (B, D) float32)."""
    u = x @ p.w_x
    gate = F.gelu((x @ p.w_gate).float(), approximate="tanh").to(DTYPE)
    if mode == "decode":
        u_c, conv_state = _causal_conv(u, p.conv, cache["conv"])
        a, b = _gates(p, u_c)
        h = a[:, 0] * cache["h"] + b[:, 0]                  # (B, D)
        y = (h[:, None] * gate.float()).to(DTYPE) @ p.w_o
        return y, {"conv": conv_state, "h": h}
    u_c, conv_state = _causal_conv(u, p.conv)
    h = rglru_scan(p, u_c)
    y = (h * gate.float()).to(DTYPE) @ p.w_o
    new_cache = None
    if mode == "prefill":
        new_cache = {"conv": conv_state.to(DTYPE), "h": h[:, -1].clone()}
    return y, new_cache


def init_rglru_cache(b: int, d: int, *, device):
    return {"conv": torch.zeros((b, CONV_W - 1, d), dtype=DTYPE,
                                device=device),
            "h": torch.zeros((b, d), dtype=torch.float32, device=device)}
