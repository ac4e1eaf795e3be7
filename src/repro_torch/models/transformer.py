"""Model assembly: the block stack, inference forward, prefill and decode.

The counterpart of ``repro/models/transformer.py`` for the serving path of
the block kinds ``attn``, ``attn_local``, ``rglru`` and ``ssd``
(recurrentgemma-2b, mamba2-1.3b, and the dense attention models).  An
``ssd`` block is ``x + ssd(norm1(x))`` with no MLP, as in the reference.
The reference stacks each period's parameters on a leading stage axis for
``lax.scan``; the port keeps one ``nn.Module`` per layer in a
``ModuleList``, in the reference's order (periods first, then the ``tail``
blocks), and its caches are one dict per layer in the same order.
`models.convert` maps both layouts onto each other.

Entry points (all inference; nothing here trains):
  init_params(cfg, generator, device)     the model, weights drawn from gen
  forward(model, tokens)                  logits of every position
  prefill(model, tokens, max_len)         last-token logits + cache
  init_cache(cfg, batch, max_len)         an empty cache
  decode_step(model, cache, tok, pos)     one-token serve step

Block kinds the port does not build yet raise ``NotImplementedError``, as do
encoder-decoder and vision-stub configurations.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.engine import resolve_device
from . import attention as A
from . import rglru as RG
from . import ssd as SSD
from .layers import Embed, MLP, RMSNorm, embed, mlp, unembed

SUPPORTED_KINDS = ("attn", "attn_local", "rglru", "ssd")

_WAITING = {
    "attn_moe": "the moe block (models/moe.py)",
    "cross": ("cross attention and the encoder "
              "(attention.cross_attention_block, encode_cross_kv)"),
}


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a configuration this port cannot build
    yet, naming the module or function that is missing."""
    for kind in dict.fromkeys(cfg.pattern):
        if kind not in SUPPORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet; it "
                f"needs {_WAITING.get(kind, f'a {kind!r} block')}")
    if cfg.enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder is not ported yet; it needs "
            f"{_WAITING['cross']}")
    if cfg.vision_patches:
        raise NotImplementedError(
            f"{cfg.name}: the VLM stub frontend is not ported yet; it needs "
            f"the VLM frontend_embeds")


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
        if kind in ("attn", "attn_local"):
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
        else:  # pragma: no cover - check_supported refuses it first
            raise NotImplementedError(kind)
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gen, device=device)


class Transformer(nn.Module):
    """The whole stack: ``embed`` (tied to the LM head), ``layers`` in the
    reference's order, ``final_norm``."""

    def __init__(self, cfg, gen, *, device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.keys = layer_keys(cfg)
        self.layers = nn.ModuleList(
            Block(key.split("_", 1)[1], cfg, gen, device=device)
            for key, _ in self.keys)
        self.embed = Embed(cfg.vocab, cfg.d_model, gen, device=device)
        self.final_norm = RMSNorm(cfg.d_model, device=device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


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
                 cache_len=None):
    h = blk.norm1(x)
    new_cache = {}
    if blk.kind in ("attn", "attn_local"):
        window = cfg.window if blk.kind == "attn_local" else None
        a_out, a_cache = A.attention_block(
            blk.attn, h, positions, cfg, mode=mode,
            cache=None if cache is None else cache.get("attn"),
            window=window, cache_len=cache_len)
        x = x + a_out
        if a_cache is not None:
            new_cache["attn"] = a_cache
    elif blk.kind == "ssd":
        s_out, s_cache = SSD.ssd_block(
            blk.ssd, h, cfg, mode=mode,
            cache=None if cache is None else cache.get("ssd"))
        if s_cache is not None:
            new_cache["ssd"] = s_cache
        return x + s_out, new_cache
    else:
        r_out, r_cache = RG.rglru_block(
            blk.rglru, h, mode=mode,
            cache=None if cache is None else cache.get("rglru"))
        x = x + r_out
        if r_cache is not None:
            new_cache["rglru"] = r_cache
    x = x + mlp(blk.mlp, blk.norm2(x))
    return x, new_cache


def _positions(tokens):
    return torch.arange(tokens.shape[1], device=tokens.device)[None] \
        .expand(tokens.shape)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(model: Transformer, tokens):
    """tokens: (B, S) integer on the model's device -> logits (B, S, V)
    bf16."""
    cfg = model.cfg
    x = embed(model.embed.tok, tokens)
    positions = _positions(tokens)
    for blk in model.layers:
        x, _ = _apply_block(blk, x, positions, cfg, mode="forward")
    x = model.final_norm(x)
    return unembed(model.embed.tok, x)


@torch.no_grad()
def prefill(model: Transformer, tokens, max_len: int):
    """Process the prompt, returning (last-token logits (B, 1, V), cache):
    one dict per layer, as `init_cache` lays it out."""
    cfg = model.cfg
    x = embed(model.embed.tok, tokens)
    positions = _positions(tokens)
    caches = []
    for blk in model.layers:
        x, nc = _apply_block(blk, x, positions, cfg, mode="prefill",
                             cache_len=max_len)
        caches.append(nc)
    x = model.final_norm(x)
    return unembed(model.embed.tok, x[:, -1:]), caches


def init_cache(cfg, batch: int, max_len: int, *, device="cuda"):
    """An empty cache: one dict per layer, in the layers' order."""
    check_supported(cfg)
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
        if kind == "attn":
            caches.append(kv(min(max_len, cfg.max_seq)))
        elif kind == "attn_local":
            caches.append(kv(min(max_len, cfg.window)))
        elif kind == "ssd":
            caches.append({"ssd": SSD.init_ssd_cache(batch, cfg,
                                                     device=dev)})
        else:
            caches.append({"rglru": RG.init_rglru_cache(batch, cfg.d_model,
                                                        device=dev)})
    return caches


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
