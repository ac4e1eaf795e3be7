"""GQA attention: prefill through the flash kernel, plain, KV-chunked,
decode.

The counterpart of ``repro/models/attention.py``.  The paths:

  * prefill / forward — `kernels.flash_attention.ops.flash_attention`: the
    CUDA kernel on the card at every prompt length, its plain version on the
    CPU.  The reference switches from ``plain_attention`` to
    ``chunked_attention`` above 2048 tokens only to bound the S x S score
    memory, which the kernel never builds;
  * ``plain_attention`` and ``chunked_attention`` — the reference's two
    ``jnp`` formulations, ported as plain functions so that the tests can
    hold them, and the kernel's path, against the reference on both sides of
    its 2048-token switch;
  * decode — one query token against the KV cache, with GQA head grouping
    and an optional sliding-window ring cache.

Numerics: the kernel and its plain version compute scores, softmax and the
PV product in float32 (as the reference's Pallas kernel and
``flash_attention_ref`` do), while the reference model's ``plain_attention``
rounds the softmax weights to bf16 before PV and its ``chunked_attention``
keeps a bf16 accumulator.  The port follows the kernel; the tests hold its
blocks to the reference model at bf16 tolerance.

Decode writes the new key and value into the ring cache in place (an
index write, exact like the reference's one-hot mix) and returns the same
tensors in the new cache.

Cross attention (whisper's decoder): `encode_cross_kv` projects the encoder
output once into a layer's keys and values, and `cross_attention_block`
attends the decoder's S queries to its T = ``enc_frames`` keys through the
flash kernel, non-causal, in every mode (S = 1 in decode).  The reference
uses ``plain_attention`` there, with the same bf16 rounding of the softmax
weights as above, which the kernel does not make.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import sqrt_head_dim
from .layers import DTYPE, _normal, param, rope

NEG = -2.0e38


class Attention(nn.Module):
    def __init__(self, d: int, n_heads: int, n_kv: int, head_dim: int, gen,
                 *, device):
        super().__init__()
        self.wq = param(_normal(gen, (d, n_heads * head_dim), d ** -0.5,
                                device=device))
        self.wk = param(_normal(gen, (d, n_kv * head_dim), d ** -0.5,
                                device=device))
        self.wv = param(_normal(gen, (d, n_kv * head_dim), d ** -0.5,
                                device=device))
        self.wo = param(_normal(gen, (n_heads * head_dim, d),
                                (n_heads * head_dim) ** -0.5, device=device))


def attn_axes():
    return {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}


def _project(p: Attention, x, n_heads, n_kv, head_dim, positions,
             rope_theta):
    b, s, _ = x.shape
    q = (x @ p.wq).reshape(b, s, n_heads, head_dim)
    k = (x @ p.wk).reshape(b, s, n_kv, head_dim)
    v = (x @ p.wv).reshape(b, s, n_kv, head_dim)
    if rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


def _gqa_scores(q, k):
    """q: (B, S, KV, G, D), k: (B, T, KV, D) -> (B, KV, G, S, T) float32."""
    return torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())


def _masked(scores, mask):
    return scores.masked_fill(~mask, NEG)


def plain_attention(q, k, v, *, causal=True, window: int | None = None,
                    q_offset=0):
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, d)
    scores = _gqa_scores(qg, k) / sqrt_head_dim(d, q.device)
    t = k.shape[1]
    qpos = torch.arange(s, device=q.device)[:, None] + q_offset
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    w = torch.softmax(_masked(scores, mask), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(b, s, h, d)


def chunked_attention(q, k, v, *, chunk: int = 1024, causal=True,
                      window: int | None = None):
    """Online-softmax walk over KV chunks with a bf16 accumulator (the
    reference's pure-jnp flash formulation)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    t = k.shape[1]
    n_chunks = (t + chunk - 1) // chunk
    pad = n_chunks * chunk - t
    if pad:
        k = torch.cat([k, k.new_zeros(b, pad, kvh, d)], dim=1)
        v = torch.cat([v, v.new_zeros(b, pad, kvh, d)], dim=1)
    qg = q.reshape(b, s, kvh, g, d)
    qpos = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, kvh, g, s), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, s, d), dtype=DTYPE, device=q.device)
    sqrt_d = sqrt_head_dim(d, q.device)
    for idx in range(n_chunks):
        kb = k[:, idx * chunk:(idx + 1) * chunk]
        vb = v[:, idx * chunk:(idx + 1) * chunk]
        scores = _gqa_scores(qg, kb) / sqrt_d
        kpos = idx * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = kpos < t
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        scores = _masked(scores, mask)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(vb.dtype), vb)
        acc = acc * alpha[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: int | None = None):
    """q: (B, 1, H, D); caches: (B, T, KV, D); lengths: (B,) valid prefix
    length (for ring caches: the number of valid slots)."""
    b, _, h, d = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    t = k_cache.shape[1]
    qg = q.reshape(b, 1, kvh, g, d)
    scores = _gqa_scores(qg, k_cache) / sqrt_head_dim(d, q.device)
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = kpos < lengths[:, None]
    if window is not None:
        mask &= kpos > (lengths[:, None] - 1 - window)
    w = torch.softmax(_masked(scores, mask[:, None, None, None]), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, d)


def attention_block(p: Attention, x, positions, cfg, *, mode, cache=None,
                    window=None, cache_len=None):
    """Full attention sub-block.  mode: forward | train | prefill | decode
    (train is forward with the gradient: `flash_attention` is then an
    autograd function over the kernels).

    Returns (out, new_cache).  Caches: dict(k, v, len) where k and v are
    (B, T, KV, D); T = min(window, cache_len) for windowed layers.  Windowed
    caches are ring buffers: the token at position p lives in slot p % T,
    both at prefill handoff and during decode.
    """
    n_heads, n_kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q, k, v = _project(p, x, n_heads, n_kv, hd, positions, cfg.rope_theta)

    if mode == "decode":
        b = x.shape[0]
        t = cache["k"].shape[1]
        pos = cache["len"]
        slot = (pos % t).long()
        rows = torch.arange(b, device=x.device)
        k_upd, v_upd = cache["k"], cache["v"]
        k_upd[rows, slot] = k[:, 0].to(k_upd.dtype)
        v_upd[rows, slot] = v[:, 0].to(v_upd.dtype)
        lengths = torch.clamp_max(pos + 1, t)
        out = decode_attention(q, k_upd, v_upd, lengths,
                               window=None)  # ring slots are all valid-masked
        y = out.reshape(b, 1, n_heads * hd) @ p.wo
        return y, {"k": k_upd, "v": v_upd, "len": pos + 1}

    causal = True if window is not None else cfg.causal
    out = flash_attention(q, k, v, causal=causal, window=window or 0)
    y = out.reshape(*x.shape[:2], n_heads * hd) @ p.wo
    new_cache = None
    if mode == "prefill" and cfg.causal:
        full = cache_len if cache_len is not None else cfg.max_seq
        t = min(window, full) if window else full
        b, s = x.shape[:2]
        keep = min(s, t)
        kk = torch.zeros((b, t, n_kv, hd), dtype=DTYPE, device=x.device)
        vv = torch.zeros((b, t, n_kv, hd), dtype=DTYPE, device=x.device)
        kk[:, :keep] = k[:, -keep:].to(DTYPE)
        vv[:, :keep] = v[:, -keep:].to(DTYPE)
        if s > t:
            # ring alignment: token p must live in slot p % t
            kk = torch.roll(kk, shifts=s % t, dims=1)
            vv = torch.roll(vv, shifts=s % t, dims=1)
        new_cache = {"k": kk, "v": vv,
                     "len": torch.full((b,), s, dtype=torch.int32,
                                       device=x.device)}
    return y, new_cache


# ---------------------------------------------------------------------------
# Cross attention (enc-dec decoders, e.g. whisper)
# ---------------------------------------------------------------------------

def cross_attention_block(p: Attention, x, enc_kv, cfg):
    """x: decoder states (B, S, D); enc_kv: dict(k, v), each (B, T, KV, hd),
    from `encode_cross_kv`.  Non-causal over the encoder positions, no RoPE
    on the queries, through `flash_attention`, which takes S <= T: a
    decoder longer than the encoder's T (1,500 frames for whisper; its
    4,096-token training rows) attends in blocks of T queries, which are
    independent without a causal mask.  Returns the block's output (B, S,
    D)."""
    n_heads, hd = cfg.n_heads, cfg.head_dim
    b, s, _ = x.shape
    t = enc_kv["k"].shape[1]
    q = (x @ p.wq).reshape(b, s, n_heads, hd)
    out = torch.cat([flash_attention(q[:, i:i + t], enc_kv["k"], enc_kv["v"],
                                     causal=False)
                     for i in range(0, s, t)], dim=1) if s > t else \
        flash_attention(q, enc_kv["k"], enc_kv["v"], causal=False)
    return out.reshape(b, s, n_heads * hd) @ p.wo


def encode_cross_kv(p: Attention, enc_out, cfg):
    """Project the encoder output (B, T, D) once into this layer's cross
    keys and values, (B, T, KV, hd) each."""
    b, t, _ = enc_out.shape
    k = (enc_out @ p.wk).reshape(b, t, cfg.n_kv, cfg.head_dim)
    v = (enc_out @ p.wv).reshape(b, t, cfg.n_kv, cfg.head_dim)
    return {"k": k, "v": v}
