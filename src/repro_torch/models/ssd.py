"""Mamba-2 SSD (state-space duality) block.

The counterpart of ``repro/models/ssd.py``: in_proj -> [z | x | B | C |
dt], a depthwise causal conv with a float32 SiLU on (x, B, C), the SSD core,
a gated RMSNorm and out_proj. Prefill runs the SSD over the prompt through
`kernels.ssd_chunk.ops.ssd_chunk` (the CUDA kernel on the card, its plain
version on the CPU), which also gives the recurrent state the cache needs;
the reference takes its plain ``ssd_chunked`` and then ``_final_state``.
Training (mode ``train``) goes through the same op, a
`torch.autograd.Function`: on the card the forward kernel and the backward
kernel (`kernels.ssd_chunk.kernel_bwd`), on the CPU the plain forward and
the plain backward (`kernels.ssd_chunk.ops`). Decode is the O(1)
recurrence ``h = a h + (dt x) (x) B; y = C . h`` in plain PyTorch, as in
the reference (it has no kernel).

``dt`` goes through ``jax.nn.softplus`` as the reference computes it,
``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` switches to the identity
above 20 and rounds differently).  The cache is ``{"conv": (B, W-1, d_inner
+ 2 N) bf16, "h": (B, H, P, N) float32}``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.ssd_chunk import ops as ssd_ops
from .layers import DTYPE, RMSNorm, _normal, param, silu
from .rglru import _causal_conv

CONV_W = 4


class SSD(nn.Module):
    def __init__(self, d: int, gen, *, n_heads: int, head_dim: int,
                 state: int, device):
        super().__init__()
        d_in = n_heads * head_dim
        self.in_proj = param(_normal(gen, (d, 2 * d_in + 2 * state + n_heads),
                                     d ** -0.5, device=device))
        self.conv = param(_normal(gen, (CONV_W, d_in + 2 * state), 0.1,
                                  device=device))
        self.A_log = param(torch.log(torch.linspace(
            1.0, 16.0, n_heads, dtype=torch.float64)).to(
                device=device, dtype=torch.float32))
        self.dt_bias = param(torch.zeros(n_heads, dtype=torch.float32,
                                         device=device))
        self.norm = RMSNorm(d_in, device=device)
        self.out_proj = param(_normal(gen, (d_in, d), d_in ** -0.5,
                                      device=device))


def ssd_axes():
    return {"in_proj": ("embed", "mlp"), "conv": (None, None),
            "A_log": (None,), "dt_bias": (None,),
            "norm": {"scale": (None,)}, "out_proj": ("mlp", "embed")}


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _split(p: SSD, x, n_heads, head_dim, state):
    d_in = n_heads * head_dim
    zxbcdt = x @ p.in_proj
    z = zxbcdt[..., :d_in]
    xs = zxbcdt[..., d_in:2 * d_in]
    bc = zxbcdt[..., 2 * d_in:2 * d_in + 2 * state]
    dt = zxbcdt[..., 2 * d_in + 2 * state:]
    return z, xs, bc, dt


def _conv(x, w, cache=None):
    """The causal conv (the reference's shifted sum, term by term in x's
    dtype), then SiLU in float32 back to x's dtype; and the new conv
    state."""
    out, new_state = _causal_conv(x, w, cache)
    return silu(out.float()).to(x.dtype), new_state


def _gate_out(p: SSD, y, z):
    """Gated RMSNorm and out_proj: y (B, S, d_inner) bf16."""
    y = p.norm(y * silu(z.float()).to(DTYPE))
    return y @ p.out_proj


def ssd_block(p: SSD, x, cfg, *, mode, cache=None):
    """mode: forward | train | prefill | decode.  cache: dict(conv (B, W-1,
    d_conv), h (B, H, P, N))."""
    nh, hd, st = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xs, bc, dt = _split(p, x, nh, hd, st)
    conv_in = torch.cat([xs, bc], dim=-1)

    if mode == "decode":
        conv_out, conv_state = _conv(conv_in, p.conv, cache["conv"])
        xs_c = conv_out[..., :nh * hd].reshape(x.shape[0], 1, nh, hd)
        bm = conv_out[..., nh * hd:nh * hd + st].float()
        cm = conv_out[..., nh * hd + st:].float()
        dtv = softplus(dt[:, 0].float() + p.dt_bias)
        a = torch.exp(-torch.exp(p.A_log)[None] * dtv)            # (B, H)
        xdt = xs_c[:, 0].float() * dtv[..., None]
        h = cache["h"] * a[..., None, None] + \
            torch.einsum("bhp,bn->bhpn", xdt, bm[:, 0])
        y = torch.einsum("bhpn,bn->bhp", h, cm[:, 0])
        y = y.reshape(x.shape[0], 1, nh * hd).to(DTYPE)
        return _gate_out(p, y, z), {"conv": conv_state, "h": h}

    conv_out, conv_state = _conv(conv_in, p.conv)
    xs_c = conv_out[..., :nh * hd].reshape(*x.shape[:2], nh, hd)
    bm = conv_out[..., nh * hd:nh * hd + st]
    cm = conv_out[..., nh * hd + st:]
    dtv = softplus(dt.float() + p.dt_bias)
    y, h = ssd_ops.ssd_chunk(xs_c, dtv, p.A_log, bm, cm,
                             chunk=cfg.ssd_chunk)
    y = _gate_out(p, y.reshape(*x.shape[:2], nh * hd), z)
    new_cache = None
    if mode == "prefill":
        new_cache = {"conv": conv_state.to(DTYPE), "h": h}
    return y, new_cache


def init_ssd_cache(b: int, cfg, *, device):
    nh, hd, st = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {"conv": torch.zeros((b, CONV_W - 1, nh * hd + 2 * st),
                                dtype=DTYPE, device=device),
            "h": torch.zeros((b, nh, hd, st), dtype=torch.float32,
                             device=device)}
