"""Gradient compression for cross-pod (DCN) reduction, the counterpart of
``repro/optim/grad_compress.py``.

Two schemes with error feedback (residual accumulation):

  * int8 stochastic-rounding quantization (8x smaller all-reduce payload);
  * top-k sparsification (magnitude): send k% of entries + indices.

Error feedback keeps both unbiased-in-the-limit: the residual (what
compression dropped) is added back before the next compression
(Karimireddy et al., 2019).

The reference draws its rounding noise from a ``jax.random`` key; the port
takes an explicit ``torch.Generator`` (uniform in [-0.5, 0.5), drawn on the
generator's device), so the noise differs and only the deterministic parts
compare bit for bit: the scale, the rounding of given noise, the top-k mask
and the residual arithmetic.
"""

from __future__ import annotations

import torch


def uniform_noise(shape, generator: torch.Generator, device=None):
    """Uniform noise in [-0.5, 0.5) of ``shape``, float32."""
    dev = generator.device if device is None else device
    return (torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=generator.device) - 0.5).to(dev)


def quantize_int8(x, generator: torch.Generator = None, *, noise=None):
    """Stochastic int8 quantization; returns (q, scale).  The noise is drawn
    from ``generator`` unless given."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    y = x / scale
    if noise is None:
        noise = uniform_noise(x.shape, generator, x.device)
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def topk_sparsify(x, frac: float):
    """Keep the top-``frac`` entries by magnitude; returns (sparse_x,
    mask)."""
    flat = x.reshape(-1)
    k = max(int(flat.shape[0] * frac), 1)
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    mask = torch.abs(x) >= thresh
    return x * mask, mask


def compress_with_feedback(grad, residual, generator=None, *,
                           method: str = "int8", topk_frac: float = 0.05,
                           noise=None):
    """(compressed_payload, new_residual).  The payload is what crosses DCN;
    decompress with `decompress`."""
    g = grad.float() + residual
    if method == "int8":
        q, scale = quantize_int8(g, generator, noise=noise)
        approx = dequantize_int8(q, scale)
        return (q, scale), g - approx
    if method == "topk":
        sparse, mask = topk_sparsify(g, topk_frac)
        return (sparse, None), g - sparse
    raise ValueError(method)


def decompress(payload, method: str = "int8"):
    if method == "int8":
        q, scale = payload
        return dequantize_int8(q, scale)
    return payload[0]


def compression_ratio(method: str, topk_frac: float = 0.05) -> float:
    return 0.25 if method == "int8" else topk_frac * 2  # value+index
