"""Shared model layers: norms, embeddings, RoPE, gated MLPs.

The counterpart of ``repro/models/layers.py``.  Conventions:

  * parameters live in ``nn.Module``s (one per layer, named as the
    reference's pytree keys, so `models.convert` maps one onto the other);
    they never require gradients: the port's model stack serves and does not
    train yet, so ``softmax_xent`` waits for the training slice;
  * compute dtype bf16, accumulation and normalisation float32, explicit
    everywhere;
  * initial weights are drawn from an explicit ``torch.Generator`` (in float32,
    then cast).  The reference's draws come from ``jax.random`` and differ;
    the tests carry the reference's weights across instead.
  * the reference annotates activations with logical sharding axes
    (``repro.parallel.sharding.shard``); on one card there is nothing to
    shard, so those calls have no counterpart here.
"""

from __future__ import annotations

import torch
from torch import nn

DTYPE = torch.bfloat16


def _normal(gen, shape, scale, dtype=DTYPE, *, device):
    """``N(0, 1) * scale`` drawn in float32 from ``gen`` and cast to
    ``dtype`` on ``device``; with no generator, an uninitialised tensor for
    `models.convert` to fill."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return x.to(device=device, dtype=dtype)


def param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device):
        super().__init__()
        self.scale = param(torch.zeros(d, dtype=torch.float32, device=device))

    def forward(self, x):
        return rmsnorm(self.scale, x)


def rmsnorm(scale, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + scale)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding (tied LM head)
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, gen, *, device):
        super().__init__()
        self.tok = param(_normal(gen, (vocab, d), d ** -0.5, device=device))


def embed(tok, tokens):
    return torch.nn.functional.embedding(tokens.long(), tok).to(DTYPE)


def unembed(tok, x):
    return torch.einsum("bsd,vd->bsv", x, tok)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float = 10_000.0):
    """x: (B, S, H, D) with D even; positions: (B, S) integer."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d: int, f: int, gen, *, device):
        super().__init__()
        self.wi_gate = param(_normal(gen, (d, f), d ** -0.5, device=device))
        self.wi_up = param(_normal(gen, (d, f), d ** -0.5, device=device))
        self.wo = param(_normal(gen, (f, d), f ** -0.5, device=device))


def silu(x):
    """``x * sigmoid(x)`` as the reference computes it in x's dtype: the
    logistic written out as ``1 / (1 + exp(-x))``, each operation rounding
    to x's dtype, which is how XLA expands ``jax.nn.sigmoid`` for bf16.  With
    it the MLP equals the reference's bit for bit on the CPU, where
    ``F.silu`` (one rounding) differs in a third of the bf16 outputs."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp(p: MLP, x, act=silu):
    h = act(x @ p.wi_gate) * (x @ p.wi_up)
    return h @ p.wo
