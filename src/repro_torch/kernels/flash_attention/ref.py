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

The gradient.  ``flash_attention_ref(..., return_lse=True)`` also gives the
rows' log-sum-exp in base 2, ``lse2 = logsumexp(scores) * log2 e``, float32
(B, H, S), as the tensor-core kernel writes it on request.
`flash_attention_bwd_plain` is the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``), FlashAttention-2's formulas in float32:
``P = 2^(x log2 e - lse2)``, ``dV = P^T dO``, ``dS = P (dO V^T - delta)``
with ``delta = rowsum(dO O)``, ``dQ = dS K / sqrt(D)``, ``dK = dS^T Q /
sqrt(D)``; `q_tile_range` is the backward's walk over the query tiles that
see a key tile (the mirror of `kv_tile_range`).  Float64 inputs are
computed in float64 throughout, so that ``torch.autograd.gradcheck`` can
hold the port's autograd function to these formulas.
"""

from __future__ import annotations

import functools
import math

import torch

from .._split import split_bf16

NEG = -2.0e38
LOG2E = 1.4426950408889634


def _acc(x):
    """The type the plain versions compute in: float64 for float64 inputs,
    float32 otherwise."""
    return x.double() if x.dtype == torch.float64 else x.float()


@functools.lru_cache(maxsize=None)
def sqrt_head_dim(d: int, device=torch.device("cpu")) -> torch.Tensor:
    """float32 ``sqrt(d)``, the divisor of the scores: a 0-dim tensor on
    ``device``, made once per device.  The scores are divided by a tensor
    on their own device, so that PyTorch divides (dividing by a Python or
    CPU scalar, it multiplies by the reciprocal, which rounds otherwise),
    and the card's copy is not made anew, with a host sync, at every call."""
    return torch.tensor(math.sqrt(d), dtype=torch.float32, device=device)


def _divisor(d, x):
    if x.dtype == torch.float64:
        return torch.tensor(math.sqrt(d), dtype=torch.float64,
                            device=x.device)
    return sqrt_head_dim(d, x.device)


def attention_mask(sq: int, t: int, *, causal: bool, window: int, device):
    """(S, T) bool: the keys each query row sees (key <= row when causal,
    key > row - window when ``window`` > 0)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((sq, t), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k, causal, window):
    """Masked scores (B, KV, G, S, T) and the mask, in the grouped
    layout."""
    d = q.shape[-1]
    qa = _acc(q)
    s = torch.einsum("bkgsd,bktd->bkgst", qa, _acc(k).to(qa.dtype)) \
        / _divisor(d, qa)
    mask = attention_mask(q.shape[3], k.shape[2], causal=causal,
                          window=window, device=q.device)
    return s.masked_fill(~mask, NEG), mask


def flash_attention_grouped(q, k, v, *, causal: bool = True,
                            window: int = 0, return_lse: bool = False):
    """The reference's ``flash_attention_ref`` in its grouped layout: q (B,
    KV, G, S, D); k, v: (B, KV, T, D) -> (B, KV, G, S, D) in q's dtype
    (and, with ``return_lse``, the rows' base-2 log-sum-exp (B, KV, G,
    S))."""
    s, _ = _scores(q, k, causal, window)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", w, _acc(v).to(w.dtype)).to(
        q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1) * LOG2E
    return out


def _grouped(x, kvh):
    """(B, S, H, D) -> (B, KV, G, S, D)."""
    b, s, h, d = x.shape
    return x.reshape(b, s, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)


def _ungrouped(x):
    """(B, KV, G, S, D) -> (B, S, H, D)."""
    b, kvh, g, s, d = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, d)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """The plain version in the model layout, as the kernel takes it: q (B,
    S, H, D), k and v (B, T, KV, D) -> (B, S, H, D), query heads grouped per
    KV head (`flash_attention_grouped` on the regrouped tensors).  With
    ``return_lse``: (out, lse2), lse2 (B, H, S) in the compute type."""
    b, s, h, _ = q.shape
    out = flash_attention_grouped(_grouped(q, k.shape[2]), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, return_lse=return_lse)
    if return_lse:
        out, lse = out
        return _ungrouped(out), lse.reshape(b, h, s)
    return _ungrouped(out)


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                            window: int = 0):
    """The backward kernel's plain version: q, o and do (B, S, H, D); k, v
    (B, T, KV, D); lse (B, H, S), the forward's base-2 log-sum-exp ->
    (dq, dk, dv) in the compute type (float32, or float64 for float64
    inputs), the query heads of a KV head's group summed into its dk and
    dv."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = _acc(_grouped(q, kvh))
    kt, vt = (_acc(x.transpose(1, 2)).to(qg.dtype) for x in (k, v))
    dog = _acc(_grouped(do, kvh)).to(qg.dtype)
    og = _acc(_grouped(o, kvh)).to(qg.dtype)
    x, mask = _scores(qg, kt, causal, window)
    lse = lse.to(qg.dtype).reshape(b, kvh, h // kvh, s, 1)
    p = torch.where(mask, torch.exp2(x * LOG2E - lse), 0.0)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, vt)
    delta = (dog * og).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    sqrt_d = _divisor(d, qg)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kt) / sqrt_d
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg) / sqrt_d
    return _ungrouped(dq), dk.transpose(1, 2), dv.transpose(1, 2)


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


def q_tile_range(k0: int, bk: int, s: int, bq: int, *, causal: bool,
                 window: int) -> range:
    """Start rows of the query tiles the backward kernel's dK/dV walk
    visits for the key tile starting at ``k0``: the rows that see one of its
    keys (row >= key when causal, row < key + window when windowed), in
    tiles of ``bq`` rows; the mirror of `kv_tile_range`."""
    q_lo = k0 if causal else 0
    q_hi = min(s, k0 + bk - 1 + window) if window > 0 else s
    return range((q_lo // bq) * bq, q_hi, bq)


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
