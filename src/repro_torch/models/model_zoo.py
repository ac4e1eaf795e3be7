"""Model zoo facade: step functions and abstract inputs per (arch, shape).

The counterpart of ``repro/models/model_zoo.py``.  Where the reference
traces with ``jax.eval_shape`` and hands out ``ShapeDtypeStruct``s, the
port builds on PyTorch's ``meta`` device: tensors with a shape and a dtype
and no storage, so a full-size configuration (grok-1-314b's 631 GB of
weights included) costs no memory.  The modality frontends are stubs by
contract: whisper takes precomputed frame embeddings, phi-3-vision
projected patch embeddings.

The training step is `transformer.loss_fn` (model, batch) -> (loss,
{"xent", "aux"}); the trainer (`runtime.trainer`) differentiates it.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeSpec
from . import transformer as TF
from .layers import DTYPE
from .transformer import init_params  # noqa: F401  (the zoo's entry point)

META = torch.device("meta")

def abstract_params(cfg: ArchConfig) -> TF.Transformer:
    """The model of ``cfg`` on the ``meta`` device (no weights drawn)."""
    return TF.Transformer(cfg, None, device=META)


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int):
    return TF.init_cache(cfg, batch, max_len, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """``meta`` stand-ins of the inputs of the step ``shape.kind``
    selects."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device=META)

    extra = {}
    if cfg.vision_patches:
        extra["frontend_embeds"] = spec((b, cfg.vision_patches, cfg.d_model),
                                        DTYPE)
    if cfg.enc_layers:
        extra["frontend_embeds"] = spec((b, cfg.enc_frames, cfg.d_model),
                                        DTYPE)
    if shape.kind == "train":
        return {"batch": {"tokens": spec((b, s)), "labels": spec((b, s)),
                          **extra}}
    if shape.kind == "prefill":
        return {"tokens": spec((b, s)), "max_len": s, **extra}
    # decode / long_decode: one new token against a seq_len-deep cache
    return {"cache": abstract_cache(cfg, b, s), "tokens": spec((b, 1)),
            "positions": spec((b, 1))}


def step_fn(cfg: ArchConfig, kind: str):
    """The step for a shape kind: `transformer.loss_fn` (model, batch),
    `transformer.prefill` (model, tokens, max_len, frontend_embeds=None) or
    `transformer.decode_step` (model, cache, tokens, positions)."""
    if kind == "train":
        return TF.loss_fn
    if kind == "prefill":
        return TF.prefill
    if kind in ("decode", "long_decode"):
        return TF.decode_step
    raise ValueError(kind)


def train_step_fn(cfg: ArchConfig):
    return step_fn(cfg, "train")
