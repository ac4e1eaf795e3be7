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
kernel's 64-key tiles and 128-row query blocks (64 rows at D 256).  The
plain versions take an optional ``head_dim``, the D whose square root
divides the scores where the tensors' D was padded with zero columns (the
autograd op's path for bf16 at D 8 or 12).  The CPU tests hold it against the
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
`flash_attention_bwd_tiled` runs the backward kernel's decomposition on the
CPU: key tiles whose walk over the group's heads and their query tiles is
cut into slices, float32 partials summed in slice order, the dQ walk over
the key tiles in range, and (``split=True``) P and dS split hi/lo into bf16
parts as the kernel feeds them to the tensor cores.
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
    """sqrt(d) as the divisor of the scores ``x``: float64 for float64
    scores, else `sqrt_head_dim` on their device."""
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


def _scores(q, k, causal, window, head_dim=None):
    """Masked scores (B, KV, G, S, T) and the mask, in the grouped
    layout; divided by sqrt(``head_dim``), by default q's D."""
    d = q.shape[-1] if head_dim is None else head_dim
    qa = _acc(q)
    s = torch.einsum("bkgsd,bktd->bkgst", qa, _acc(k).to(qa.dtype)) \
        / _divisor(d, qa)
    mask = attention_mask(q.shape[3], k.shape[2], causal=causal,
                          window=window, device=q.device)
    return s.masked_fill(~mask, NEG), mask


def flash_attention_grouped(q, k, v, *, causal: bool = True,
                            window: int = 0, return_lse: bool = False,
                            head_dim=None):
    """The reference's ``flash_attention_ref`` in its grouped layout: q (B,
    KV, G, S, D); k, v: (B, KV, T, D) -> (B, KV, G, S, D) in q's dtype
    (and, with ``return_lse``, the rows' base-2 log-sum-exp (B, KV, G,
    S)).  ``head_dim``: the D whose square root divides the scores, where
    the tensors' D was padded with zero columns (default: their own)."""
    s, _ = _scores(q, k, causal, window, head_dim)
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
                        return_lse: bool = False, head_dim=None):
    """The plain version in the model layout, as the kernel takes it: q (B,
    S, H, D), k and v (B, T, KV, D) -> (B, S, H, D), query heads grouped per
    KV head (`flash_attention_grouped` on the regrouped tensors).  With
    ``return_lse``: (out, lse2), lse2 (B, H, S) in the compute type.
    ``head_dim`` as in `flash_attention_grouped`."""
    b, s, h, _ = q.shape
    out = flash_attention_grouped(_grouped(q, k.shape[2]), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, return_lse=return_lse,
                                  head_dim=head_dim)
    if return_lse:
        out, lse = out
        return _ungrouped(out), lse.reshape(b, h, s)
    return _ungrouped(out)


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                            window: int = 0, head_dim=None):
    """The backward kernel's plain version: q, o and do (B, S, H, D); k, v
    (B, T, KV, D); lse (B, H, S), the forward's base-2 log-sum-exp ->
    (dq, dk, dv) in the compute type (float32, or float64 for float64
    inputs), the query heads of a KV head's group summed into its dk and
    dv.  ``head_dim`` as in `flash_attention_grouped`."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = _acc(_grouped(q, kvh))
    kt, vt = (_acc(x.transpose(1, 2)).to(qg.dtype) for x in (k, v))
    dog = _acc(_grouped(do, kvh)).to(qg.dtype)
    og = _acc(_grouped(o, kvh)).to(qg.dtype)
    x, mask = _scores(qg, kt, causal, window, head_dim)
    lse = lse.to(qg.dtype).reshape(b, kvh, h // kvh, s, 1)
    p = torch.where(mask, torch.exp2(x * LOG2E - lse), 0.0)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, vt)
    delta = (dog * og).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    sqrt_d = _divisor(d if head_dim is None else head_dim, qg)
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
                          bq: int = 64, bk: int = 64, split: bool = False,
                          head_dim=None):
    """The CUDA kernels' algorithm on the CPU, in the grouped layout of
    `flash_attention_grouped`: query tiles of ``bq`` rows walk the KV tiles of
    ``bk`` keys that `kv_tile_range` keeps, in order, with the online
    softmax (masked scores at -inf contribute 0) in float32: each tile's
    weights ``P`` and row sums are taken before the accumulator, rescaled
    by the moved max, adds ``P V``.  ``split``: the weights times V as
    ``P_hi V + P_lo V`` (the tensor-core kernel, whose tiles are ``bk`` 64
    and ``bq`` 128, or 64 at D above 128; a warpgroup's 64 rows skip a tile
    none of them sees, which leaves its state as visiting it would).
    ``head_dim`` as in `flash_attention_grouped`."""
    d = q.shape[-1] if head_dim is None else head_dim
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


def flash_attention_bwd_tiled(q, k, v, o, do, lse, *, causal: bool = True,
                              window: int = 0, bk: int = 64, bq: int = 64,
                              head_slices: int = 1, split: bool = True):
    """The backward kernel's decomposition on the CPU, in float32, same
    arguments and results as `flash_attention_bwd_plain`.  dK and dV: for
    each key tile of ``bk`` keys, the walk over the group's query heads in
    order, each over the ``bq``-row query tiles of `q_tile_range`, is cut
    into ``head_slices`` slices of equal length (step ``sigma n / slices``
    to ``(sigma + 1) n / slices``); each slice sums its steps into a float32
    partial, and the partials are added in slice order.  dQ: for each
    ``bq``-row query tile, the ``bk``-key tiles of `kv_tile_range` in
    order.  ``split``: P and dS enter the dV, dK and dQ products as their
    bf16 hi and lo parts (`kernels._split.split_bf16`), each product exact
    in float32 for bf16 operands.  The kernel's tiles are ``bk = bq = 64``;
    its slice count is its own plan (``flash_attention_bwd_slices``)."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg, dog, og = (_grouped(x, kvh).float() for x in (q, do, o))
    kt, vt = (x.transpose(1, 2).float() for x in (k, v))
    lse = lse.float().reshape(b, kvh, g, s)
    delta = (dog * og).sum(-1)
    sqrt_d = sqrt_head_dim(d)
    parts = split_bf16 if split else (lambda w: (w,))

    def p_and_ds(rows, keys, head):
        """P and dS (B, KV, [G,] rows, keys) of one tile; ``head`` None for
        all of the group's heads."""
        hs = slice(None) if head is None else head
        qt, dot = qg[:, :, hs, rows], dog[:, :, hs, rows]
        kk, vv = kt[:, :, keys], vt[:, :, keys]
        if head is None:
            kk, vv = kk[:, :, None], vv[:, :, None]
        x = torch.matmul(qt, kk.transpose(-1, -2)) / sqrt_d
        mask = attention_mask(s, t, causal=causal, window=window,
                              device=q.device)[rows, keys]
        p = torch.where(mask, torch.exp2(
            x * LOG2E - lse[:, :, hs, rows, None]), 0.0)
        dp = torch.matmul(dot, vv.transpose(-1, -2))
        return p, p * (dp - delta[:, :, hs, rows, None]), qt, dot, kk

    dk = torch.zeros(b, kvh, t, d)
    dv = torch.zeros(b, kvh, t, d)
    for k0 in range(0, t, bk):
        keys = slice(k0, min(k0 + bk, t))
        steps = [(head, i0) for head in range(g)
                 for i0 in q_tile_range(k0, bk, s, bq, causal=causal,
                                        window=window)]
        n = len(steps)
        for sigma in range(head_slices):
            part_k = torch.zeros(b, kvh, keys.stop - k0, d)
            part_v = torch.zeros_like(part_k)
            for head, i0 in steps[sigma * n // head_slices:
                                  (sigma + 1) * n // head_slices]:
                rows = slice(i0, min(i0 + bq, s))
                p, ds, qt, dot, _ = p_and_ds(rows, keys, head)
                for w in parts(p):
                    part_v += torch.matmul(w.transpose(-1, -2), dot)
                for w in parts(ds):
                    part_k += torch.matmul(w.transpose(-1, -2), qt)
            dk[:, :, keys] += part_k
            dv[:, :, keys] += part_v
    dq = torch.zeros(b, kvh, g, s, d)
    for q0 in range(0, s, bq):
        rows = slice(q0, min(q0 + bq, s))
        acc = torch.zeros(b, kvh, g, rows.stop - q0, d)
        for j0 in kv_tile_range(q0, bq, t, bk, causal=causal, window=window):
            _, ds, _, _, kk = p_and_ds(rows, slice(j0, min(j0 + bk, t)),
                                       None)
            for w in parts(ds):
                acc += torch.matmul(w, kk)
        dq[:, :, :, rows] = acc
    return (_ungrouped(dq / sqrt_d), (dk / sqrt_d).transpose(1, 2),
            dv.transpose(1, 2))
