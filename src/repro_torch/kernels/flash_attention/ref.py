"""Plain PyTorch version of the flash attention kernel.

`flash_attention_grouped` is the counterpart of
``repro/kernels/flash_attention/ref.py::flash_attention_ref``, op for op, in
its (B, KV, G, S, D) layout: float32 scores ``q k^T / sqrt(D)``, the causal
and sliding-window mask (masked scores set to ``NEG``), the softmax in
float32, the PV product in float32, the result cast to q's dtype.
`flash_attention_ref` is the same in the model layout the kernel takes.
The CPU path and the tests use them; on the card `flash_attention_ref` is
the yardstick the kernel is held against.

`flash_attention_tiled` runs the CUDA kernels' algorithm on the CPU: the
query tiles, the KV tiles each visits (`kv_tile_range`, the skipping of
dead tiles), the online softmax.  With ``split=True`` it also rounds as the
tensor-core kernel does: the float32 weights split hi/lo into bf16
(`kernels._split.split_bf16`) and ``P_hi V + P_lo V`` in float32, on that
kernel's 128-row query and 64-key tiles.  The CPU tests hold it against the
plain version at small tiles and at the kernels' own, so the tile walk and
the split are tested here and not only on the card.
"""

from __future__ import annotations

import functools
import math

import torch

from .._split import split_bf16

NEG = -2.0e38


@functools.lru_cache(maxsize=None)
def sqrt_head_dim(d: int, device=torch.device("cpu")) -> torch.Tensor:
    """float32 ``sqrt(d)``, the divisor of the scores: a 0-dim tensor on
    ``device``, made once per device.  The scores are divided by a tensor
    on their own device, so that PyTorch divides (dividing by a Python or
    CPU scalar, it multiplies by the reciprocal, which rounds otherwise),
    and the card's copy is not made anew, with a host sync, at every call."""
    return torch.tensor(math.sqrt(d), dtype=torch.float32, device=device)


def flash_attention_grouped(q, k, v, *, causal: bool = True,
                            window: int = 0):
    """The reference's ``flash_attention_ref`` in its grouped layout: q (B,
    KV, G, S, D); k, v: (B, KV, T, D) -> (B, KV, G, S, D) in q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bkgsd,bktd->bkgst", q.float(), k.float()) \
        / sqrt_head_dim(d, q.device)
    sq, t = q.shape[3], k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((sq, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, NEG)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,bktd->bkgsd", w, v.float()).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """The plain version in the model layout, as the kernel takes it: q (B,
    S, H, D), k and v (B, T, KV, D) -> (B, S, H, D), query heads grouped per
    KV head (`flash_attention_grouped` on the regrouped tensors)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)
    out = flash_attention_grouped(qg, k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal, window=window)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def kv_tile_range(q0: int, bq: int, t: int, bk: int, *, causal: bool,
                  window: int) -> range:
    """Start keys of the KV tiles the kernel visits for the query tile
    starting at ``q0``: tiles wholly above the diagonal or wholly before the
    window of the tile's first row are skipped."""
    k_lo, k_hi = 0, t
    if causal:
        k_hi = min(t, q0 + bq)
    if window > 0:
        k_lo = max(0, q0 - window + 1)
    return range((k_lo // bk) * bk, k_hi, bk)


def flash_attention_tiled(q, k, v, *, causal: bool = True, window: int = 0,
                          bq: int = 64, bk: int = 64, split: bool = False):
    """The CUDA kernels' algorithm on the CPU, in the grouped layout of
    `flash_attention_grouped`: query tiles of ``bq`` rows walk the KV tiles of
    ``bk`` keys that `kv_tile_range` keeps, in order, with the online
    softmax (masked scores at -inf contribute 0) in float32.  ``split``:
    the weights times V as ``P_hi V + P_lo V`` (the tensor-core kernel,
    whose tiles are ``bq`` 128 and ``bk`` 64)."""
    d = q.shape[-1]
    sq, t = q.shape[3], k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    dev = q.device
    sqrt_d = sqrt_head_dim(d, dev)
    out = torch.empty(qf.shape, dtype=torch.float32, device=dev)
    for q0 in range(0, sq, bq):
        qt = qf[..., q0:q0 + bq, :]
        rows = torch.arange(q0, q0 + qt.shape[-2], device=dev)[:, None]
        m = torch.full(qt.shape[:-1], float("-inf"), device=dev)
        l = torch.zeros(qt.shape[:-1], device=dev)
        acc = torch.zeros(qt.shape, device=dev)
        for j0 in kv_tile_range(q0, bq, t, bk, causal=causal, window=window):
            kt, vt = kf[..., j0:j0 + bk, :], vf[..., j0:j0 + bk, :]
            x = torch.einsum("bkgsd,bktd->bkgst", qt, kt) / sqrt_d
            keys = torch.arange(j0, j0 + kt.shape[-2], device=dev)[None, :]
            ok = torch.ones(x.shape[-2:], dtype=torch.bool, device=dev)
            if causal:
                ok &= keys <= rows
            if window > 0:
                ok &= keys > rows - window
            x = torch.where(ok, x, float("-inf"))
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.where(m_new == float("-inf"), 1.0,
                                torch.exp(m - m_new))
            p = torch.where(x == float("-inf"), 0.0,
                            torch.exp(x - m_new[..., None]))
            l = l * alpha + p.sum(-1)
            if split:
                hi, lo = split_bf16(p)
                pv = torch.einsum("bkgst,bktd->bkgsd", hi, vt) + \
                    torch.einsum("bkgst,bktd->bkgsd", lo, vt)
            else:
                pv = torch.einsum("bkgst,bktd->bkgsd", p, vt)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[..., q0:q0 + bq, :] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)
