"""Model assembly: the block stack, the training loss, inference forward,
prefill and decode.

The counterpart of ``repro/models/transformer.py``, over every
block kind of the reference: ``attn``, ``attn_local``, ``attn_moe`` (the
MoE MLP, `models.moe`), ``cross`` (self attention, then cross attention to
the encoder, then the MLP), ``rglru`` and ``ssd`` (``x + ssd(norm1(x))``
with no MLP, as in the reference).  The reference stacks each period's
parameters on a leading stage axis for ``lax.scan``; the port keeps one
``nn.Module`` per layer in a ``ModuleList``, in the reference's order
(periods first, then the ``tail`` blocks), and its caches are one dict per
layer in the same order.  `models.convert` maps both layouts onto each
other.

The modality frontends are stubs, as in the reference: an encoder-decoder
configuration (whisper) takes precomputed frame embeddings (B, enc_frames,
D) as ``frontend_embeds`` and runs ``encoder`` (``enc_layers`` ``attn``
blocks, non-causal, RoPE on the frame positions) and ``enc_norm`` over
them; each ``cross`` block projects the result into its keys and values,
which prefill leaves in the layer's ``xattn`` cache for decode.  A VLM
configuration (phi-3-vision) takes patch embeddings (B, vision_patches, D)
that replace the first ``vision_patches`` token embeddings; without them it
runs on the tokens alone.  The MoE aux loss is summed over the layers by the
training forward and weighs 0.01 in `loss_fn`, as in the reference; the
serving paths drop it.

Training: `train_forward` runs with the gradient, each layer under
``torch.utils.checkpoint`` (``use_reentrant=False``), the counterpart of the
reference's ``jax.checkpoint`` on each period: a layer keeps only its input
for the backward pass and runs again inside it.  Attention and the RG-LRU
scan differentiate through their kernels' autograd functions on the card
(the flash backward kernel, the scan in reverse); an ``ssd`` layer trains on
the CPU only (see `kernels.ssd_chunk.ops`).  The parameters must require
grad (``model.requires_grad_()``; the trainer sets it).

Entry points:
  init_params(cfg, generator, device)     the model, weights drawn from gen
  loss_fn(model, batch)                   next-token CE (+ 0.01 MoE aux)
  train_forward(model, tokens)            logits and aux, with the gradient
  forward(model, tokens)                  logits of every position
  prefill(model, tokens, max_len)         last-token logits + cache
  init_cache(cfg, batch, max_len)         an empty cache
  decode_step(model, cache, tok, pos)     one-token serve step
  param_axes(cfg) / cache_axes(cfg)       logical sharding axes of every
                                          parameter / cache leaf

``forward`` and ``prefill`` take ``frontend_embeds=`` as the reference's
do.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.engine import resolve_device
from . import attention as A
from . import moe as MOE
from . import rglru as RG
from . import ssd as SSD
from .layers import (DTYPE, Embed, MLP, RMSNorm, embed, embed_axes, mlp,
                     mlp_axes, rmsnorm_axes, softmax_xent, unembed)

ATTN_KINDS = ("attn", "attn_local", "attn_moe", "cross")


def tail_pattern(cfg):
    """Blocks left over when n_layers is not a multiple of the period."""
    return cfg.pattern[: cfg.n_layers % len(cfg.pattern)]


def layer_keys(cfg):
    """(reference key, period or None) of every layer, in the reference's
    order: ``b{i}_{kind}`` of each period (a configuration shorter than its
    pattern still runs one period, as the reference's stage scan does), then
    the tail's ``t{i}_{kind}``."""
    keys = [(f"b{i}_{kind}", period)
            for period in range(max(cfg.n_periods, 1))
            for i, kind in enumerate(cfg.pattern)]
    keys += [(f"t{i}_{kind}", None) for i, kind in enumerate(tail_pattern(cfg))]
    return keys


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, kind: str, cfg, gen, *, device):
        super().__init__()
        self.kind = kind
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        if kind in ATTN_KINDS:
            self.attn = A.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                    cfg.head_dim, gen, device=device)
        elif kind == "rglru":
            self.rglru = RG.RGLRU(cfg.d_model, gen, device=device)
        elif kind == "ssd":
            # norm1 and the SSD only: the reference gives it no MLP
            self.ssd = SSD.SSD(cfg.d_model, gen, n_heads=cfg.ssm_heads,
                               head_dim=cfg.ssm_head_dim,
                               state=cfg.ssm_state, device=device)
            return
        else:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        if kind == "attn_moe":
            self.moe = MOE.MoE(cfg.d_model, cfg.d_ff, cfg.moe.n_experts, gen,
                               device=device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, gen, device=device)
        if kind == "cross":
            self.xattn = A.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                     cfg.head_dim, gen, device=device)
            self.norm3 = RMSNorm(cfg.d_model, device=device)


class Transformer(nn.Module):
    """The whole stack: ``embed`` (tied to the LM head), ``layers`` in the
    reference's order, ``final_norm``; for an encoder-decoder configuration
    also ``encoder`` (``enc_layers`` ``attn`` blocks) and ``enc_norm``."""

    def __init__(self, cfg, gen, *, device):
        super().__init__()
        self.cfg = cfg
        self.keys = layer_keys(cfg)
        self.layers = nn.ModuleList(
            Block(key.split("_", 1)[1], cfg, gen, device=device)
            for key, _ in self.keys)
        self.embed = Embed(cfg.vocab, cfg.d_model, gen, device=device)
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        if cfg.enc_layers:
            self.encoder = nn.ModuleList(
                Block("attn", cfg, gen, device=device)
                for _ in range(cfg.enc_layers))
            self.enc_norm = RMSNorm(cfg.d_model, device=device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


def _block_axes(kind: str, cfg):
    """Logical axes of one block's parameters, nested as its modules."""
    ax = {"norm1": rmsnorm_axes()}
    if kind in ATTN_KINDS:
        ax["attn"] = A.attn_axes()
        ax["norm2"] = rmsnorm_axes()
        if kind == "attn_moe":
            es = "expert" if cfg.moe.n_experts % 16 == 0 else "ffn"
            ax["moe"] = MOE.moe_axes(es)
        else:
            ax["mlp"] = mlp_axes()
        if kind == "cross":
            ax["xattn"] = A.attn_axes()
            ax["norm3"] = rmsnorm_axes()
    elif kind == "rglru":
        ax["rglru"] = RG.rglru_axes()
        ax["norm2"] = rmsnorm_axes()
        ax["mlp"] = mlp_axes()
    elif kind == "ssd":
        ax["ssd"] = SSD.ssd_axes()
    return ax


def _leaves(tree, prefix=""):
    """(dotted name under ``prefix``, leaf) of every leaf of a nested
    dict."""
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        if isinstance(sub, dict):
            yield from _leaves(sub, path + ".")
        else:
            yield path, sub


def param_axes(cfg) -> dict:
    """The logical axes of every parameter, keyed as
    ``Transformer.named_parameters()``.  A layer's leaves carry its own
    axes; the reference's stage-stacked leaves add a leading ``"stage"``
    (`models.convert.named_to_tree` lines the two up)."""
    axes = {**dict(_leaves(embed_axes(), "embed.")),
            **dict(_leaves(rmsnorm_axes(), "final_norm."))}
    for i, (key, _) in enumerate(layer_keys(cfg)):
        axes.update(_leaves(_block_axes(key.split("_", 1)[1], cfg),
                            f"layers.{i}."))
    for i in range(cfg.enc_layers):
        axes.update(_leaves(_block_axes("attn", cfg), f"encoder.{i}."))
    if cfg.enc_layers:
        axes.update(_leaves(rmsnorm_axes(), "enc_norm."))
    return axes


def init_params(cfg, generator: torch.Generator, *, device="cuda"):
    """The model of ``cfg`` on ``device`` (the card by default; raises
    without one unless ``device="cpu"``), weights drawn from
    ``generator``."""
    dev = resolve_device(device)
    with torch.no_grad():
        return Transformer(cfg, generator, device=dev)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _apply_block(blk: Block, x, positions, cfg, *, mode, cache=None,
                 cache_len=None, enc_kv=None):
    """(new x, new cache) of one block (the serving modes)."""
    return _run_block(blk, x, positions, cfg, mode=mode, cache=cache,
                      cache_len=cache_len, enc_kv=enc_kv)[:2]


def _run_block(blk: Block, x, positions, cfg, *, mode, cache=None,
               cache_len=None, enc_kv=None):
    """(new x, new cache, MoE aux loss: a float32 scalar, 0 for other
    blocks)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = blk.norm1(x)
    new_cache = {}
    if blk.kind in ATTN_KINDS:
        window = cfg.window if blk.kind == "attn_local" else None
        a_out, a_cache = A.attention_block(
            blk.attn, h, positions, cfg, mode=mode,
            cache=None if cache is None else cache.get("attn"),
            window=window, cache_len=cache_len)
        x = x + a_out
        if a_cache is not None:
            new_cache["attn"] = a_cache
        if blk.kind == "cross":
            # the encoder's keys and values: from the cache in decode,
            # projected by the caller otherwise (and cached by prefill)
            kv = cache["xattn"] if cache and "xattn" in cache else enc_kv
            if mode in ("prefill", "decode"):
                new_cache["xattn"] = kv
            x = x + A.cross_attention_block(blk.xattn, blk.norm3(x), kv, cfg)
    elif blk.kind == "ssd":
        s_out, s_cache = SSD.ssd_block(
            blk.ssd, h, cfg, mode=mode,
            cache=None if cache is None else cache.get("ssd"))
        if s_cache is not None:
            new_cache["ssd"] = s_cache
        return x + s_out, new_cache, aux
    else:
        r_out, r_cache = RG.rglru_block(
            blk.rglru, h, mode=mode,
            cache=None if cache is None else cache.get("rglru"))
        x = x + r_out
        if r_cache is not None:
            new_cache["rglru"] = r_cache
    h2 = blk.norm2(x)
    if blk.kind == "attn_moe":
        m_out, aux = MOE.moe_mlp(blk.moe, h2, top_k=cfg.moe.top_k,
                                 capacity_factor=cfg.moe.capacity_factor,
                                 group_size=cfg.moe_group)
    else:
        m_out = mlp(blk.mlp, h2)
    return x + m_out, new_cache, aux


def _positions(tokens):
    return torch.arange(tokens.shape[1], device=tokens.device)[None] \
        .expand(tokens.shape)


def _run_encoder(model: Transformer, frontend_embeds):
    """The whisper-style encoder over precomputed (stub) frame embeddings
    (B, T, D): non-causal attention through the flash kernel, RoPE on the
    frame positions, then ``enc_norm``."""
    cfg = model.cfg
    if frontend_embeds is None:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder model: pass its frame "
            f"embeddings (B, {cfg.enc_frames}, {cfg.d_model}) as "
            f"frontend_embeds (the reference's _run_encoder fails without "
            f"them too)")
    x = frontend_embeds.to(DTYPE)
    pos = _positions(x[..., 0])
    for lp in model.encoder:
        q, k, v = A._project(lp.attn, lp.norm1(x), cfg.n_heads, cfg.n_kv,
                             cfg.head_dim, pos, cfg.rope_theta)
        a = A.flash_attention(q, k, v, causal=False)
        x = x + a.reshape(*x.shape[:2], -1) @ lp.attn.wo
        x = x + mlp(lp.mlp, lp.norm2(x))
    return model.enc_norm(x)


def _inputs(model: Transformer, tokens, frontend_embeds):
    """(embedded tokens with the VLM stub's patches in place, positions,
    the encoder's output or None)."""
    cfg = model.cfg
    x = embed(model.embed.tok, tokens)
    n = cfg.vision_patches
    if n and frontend_embeds is not None:
        if tokens.shape[1] < n or frontend_embeds.shape[1] != n:
            raise ValueError(
                f"{cfg.name}: {n} patch embeddings replace the first {n} "
                f"of the prompt's {tokens.shape[1]} token embeddings; got "
                f"{frontend_embeds.shape[1]} patches (the reference fails "
                f"on a shorter prompt too)")
        x = torch.cat([frontend_embeds.to(DTYPE), x[:, n:]], dim=1)
    enc_out = _run_encoder(model, frontend_embeds) if cfg.enc_layers \
        else None
    return x, _positions(tokens), enc_out


def _cross_kv(blk: Block, enc_out, cfg):
    return None if enc_out is None else \
        A.encode_cross_kv(blk.xattn, enc_out, cfg)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_layer(blk: Block, cfg, positions):
    """One layer as a function of its input (and the encoder's output, for
    a ``cross`` layer, whose keys and values it projects inside), for
    `checkpoint`: (new x, aux)."""
    def run(x, enc_out):
        x, _, aux = _run_block(blk, x, positions, cfg, mode="train",
                               enc_kv=_cross_kv(blk, enc_out, cfg))
        return x, aux
    return run


def train_forward(model: Transformer, tokens, *, frontend_embeds=None):
    """tokens: (B, S) integer on the model's device -> (logits (B, S, V)
    bf16, the MoE aux loss summed over the layers), with the gradient; each
    layer runs under ``torch.utils.checkpoint`` and again in the backward
    pass (no random state to keep: the model draws nothing)."""
    cfg = model.cfg
    x, positions, enc_out = _inputs(model, tokens, frontend_embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in model.layers:
        x, aux = checkpoint(_train_layer(blk, cfg, positions), x, enc_out,
                            use_reentrant=False, preserve_rng_state=False)
        aux_total = aux_total + aux
    x = model.final_norm(x)
    return unembed(model.embed.tok, x), aux_total


def loss_fn(model: Transformer, batch):
    """The reference's ``loss_fn``: next-token cross entropy of the logits
    at positions 0 .. S-2 against the labels at 1 .. S-1 (``mask``
    optional), plus 0.01 times the MoE aux loss.  batch: dict(tokens,
    labels, optional mask and frontend_embeds) on the model's device.
    Returns (loss, {"xent", "aux"}), float32 scalars."""
    logits, aux = train_forward(model, batch["tokens"],
                                frontend_embeds=batch.get("frontend_embeds"))
    loss = softmax_xent(logits[:, :-1], batch["labels"][:, 1:],
                        batch.get("mask"))
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(model: Transformer, tokens, *, frontend_embeds=None):
    """tokens: (B, S) integer on the model's device -> logits (B, S, V)
    bf16."""
    cfg = model.cfg
    x, positions, enc_out = _inputs(model, tokens, frontend_embeds)
    for blk in model.layers:
        x, _ = _apply_block(blk, x, positions, cfg, mode="forward",
                            enc_kv=_cross_kv(blk, enc_out, cfg))
    x = model.final_norm(x)
    return unembed(model.embed.tok, x)


@torch.no_grad()
def prefill(model: Transformer, tokens, max_len: int, *,
            frontend_embeds=None):
    """Process the prompt, returning (last-token logits (B, 1, V), cache):
    one dict per layer, as `init_cache` lays it out."""
    cfg = model.cfg
    x, positions, enc_out = _inputs(model, tokens, frontend_embeds)
    caches = []
    for blk in model.layers:
        x, nc = _apply_block(blk, x, positions, cfg, mode="prefill",
                             cache_len=max_len,
                             enc_kv=_cross_kv(blk, enc_out, cfg))
        caches.append(nc)
    x = model.final_norm(x)
    return unembed(model.embed.tok, x[:, -1:]), caches


def init_cache(cfg, batch: int, max_len: int, *, device="cuda"):
    """An empty cache: one dict per layer, in the layers' order (a
    ``cross`` layer's ``xattn`` holds the encoder's keys and values)."""
    dev = resolve_device(device)

    def kv(t):
        shape = (batch, t, cfg.n_kv, cfg.head_dim)
        return {"attn": {
            "k": torch.zeros(shape, dtype=A.DTYPE, device=dev),
            "v": torch.zeros(shape, dtype=A.DTYPE, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}}

    caches = []
    for key, _ in layer_keys(cfg):
        kind = key.split("_", 1)[1]
        if kind in ("attn", "attn_moe", "cross"):
            caches.append(kv(min(max_len, cfg.max_seq)))
            if kind == "cross":
                shape = (batch, cfg.enc_frames, cfg.n_kv, cfg.head_dim)
                caches[-1]["xattn"] = {
                    "k": torch.zeros(shape, dtype=A.DTYPE, device=dev),
                    "v": torch.zeros(shape, dtype=A.DTYPE, device=dev)}
        elif kind == "attn_local":
            caches.append(kv(min(max_len, cfg.window)))
        elif kind == "ssd":
            caches.append({"ssd": SSD.init_ssd_cache(batch, cfg,
                                                     device=dev)})
        else:
            caches.append({"rglru": RG.init_rglru_cache(batch, cfg.d_model,
                                                        device=dev)})
    return caches


def cache_axes(cfg) -> list:
    """Logical sharding axes of every cache leaf, laid out as `init_cache`
    (one dict per layer).

    KV heads shard over the model axis when divisible (pruned otherwise —
    MQA caches fall back to batch sharding); SSD/RG-LRU states shard their
    head/feature dims.
    """
    def axes_for(kind):
        if kind in ATTN_KINDS:
            c = {"attn": {"k": ("kv_batch", "kv_seq", "kv_heads", None),
                          "v": ("kv_batch", "kv_seq", "kv_heads", None),
                          "len": ("kv_batch",)}}
            if kind == "cross":
                c["xattn"] = {"k": ("kv_batch", None, "kv_heads", None),
                              "v": ("kv_batch", None, "kv_heads", None)}
            return c
        if kind == "rglru":
            return {"rglru": {"conv": ("kv_batch", None, "mlp"),
                              "h": ("kv_batch", "mlp")}}
        if kind == "ssd":
            return {"ssd": {"conv": ("kv_batch", None, None),
                            "h": ("kv_batch", "heads", None, None)}}
        raise ValueError(kind)

    return [axes_for(key.split("_", 1)[1]) for key, _ in layer_keys(cfg)]


@torch.no_grad()
def decode_step(model: Transformer, cache, tokens, positions):
    """One serve step.  tokens: (B, 1); positions: (B, 1) absolute
    positions.  Returns (logits (B, 1, V), new cache); attention caches are
    written in place (see `models.attention`)."""
    cfg = model.cfg
    x = embed(model.embed.tok, tokens)
    new_caches = []
    for blk, layer_cache in zip(model.layers, cache):
        x, nc = _apply_block(blk, x, positions, cfg, mode="decode",
                             cache=layer_cache)
        new_caches.append(nc)
    x = model.final_norm(x)
    return unembed(model.embed.tok, x), new_caches
