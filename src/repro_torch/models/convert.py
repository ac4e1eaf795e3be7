"""Carry the reference's parameters and caches across to the port.

The counterpart, for the model stack, of `core.convert` for lowered tables.
The reference's parameter pytree (``repro.models.transformer.init_params``)
and cache pytree (``prefill`` / ``init_cache``) arrive as nested dicts of
numpy arrays.  Periods are stacked on a leading stage axis there, keyed
``b{i}_{kind}``; tail blocks are keyed ``t{i}_{kind}`` and have no stage
axis.  The port keeps one module, and one cache dict, per layer, in the
same order (`transformer.layer_keys`).  An encoder-decoder model's
``encoder`` blocks are stacked on a leading ``enc_layers`` axis there, with
``enc_norm`` beside them; a ``cross`` block carries ``xattn`` and ``norm3``
and its cache an ``xattn`` dict (k, v); an ``attn_moe`` block carries
``moe`` (``router`` float32, the experts bf16).  `params_to_tree` and
`cache_to_tree` lay the port's tensors out as the reference's trees (on any
device, ``meta`` included), so shapes and dtypes compare leaf for leaf.

bf16 leaves come as numpy arrays of the ``ml_dtypes`` bfloat16 type, which
``torch.from_numpy`` refuses; they go through float32 and back to bf16, and
both steps are exact.  `cache_to_numpy` gives bf16 leaves as float32 arrays
(the port does not import ``ml_dtypes``): the values are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.engine import resolve_device
from .layers import DTYPE
from .transformer import Transformer, layer_keys

# the dtype of each cache leaf (as `transformer.init_cache` makes them)
CACHE_DTYPES = {"k": DTYPE, "v": DTYPE, "len": torch.int32, "conv": DTYPE,
                "h": torch.float32}


def _tensor(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def _leaves(tree, prefix=""):
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        if isinstance(sub, dict):
            yield from _leaves(sub, path + ".")
        else:
            yield path, sub


def _pick(sub, i):
    """Slice ``i`` of every leaf of a stacked subtree."""
    return {n: _pick(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for n, v in sub.items()}


def _layer_tree(tree, key, period):
    """One layer's subtree: the stage slice of a period block, or a tail
    block as it is."""
    if period is None:
        return tree["tail"][key]
    return _pick(tree["stages"][key], period)


def _stack(trees):
    """One tree whose leaves stack those of ``trees`` (alike) on a new
    leading axis."""
    return {n: _stack([t[n] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[n] for t in trees])
            for n, v in trees[0].items()}


def _stacked_by_layer(keys, per_layer):
    """The reference's layout of per-layer subtrees: period blocks stacked
    under ``stages``, tail blocks as they are under ``tail``."""
    stages: dict = {}
    tail: dict = {}
    for (key, period), sub in zip(keys, per_layer):
        if period is None:
            tail[key] = sub
        else:
            stages.setdefault(key, []).append(sub)
    out = {"stages": {key: _stack(subs) for key, subs in stages.items()}}
    if tail:
        out["tail"] = tail
    return out


@torch.no_grad()
def fill_module(module, tree) -> None:
    """Copy the reference's parameter subtree ``tree`` (nested dicts of
    arrays, keyed as the module's parameters) into ``module``; every
    parameter must be given, with its shape and dtype."""
    filled = set()
    for name, value in _leaves(tree):
        target = module.get_parameter(name)
        src = _tensor(value, target.device)
        if src.shape != target.shape or src.dtype != target.dtype:
            raise ValueError(f"{name}: reference leaf {tuple(src.shape)} "
                             f"{src.dtype}, port parameter "
                             f"{tuple(target.shape)} {target.dtype}")
        target.copy_(src)
        filled.add(name)
    missing = sorted(set(n for n, _ in module.named_parameters()) - filled)
    if missing:
        raise ValueError(f"reference tree lacks parameters {missing}")


def params_from_numpy(cfg, tree, device="cuda") -> Transformer:
    """The port's model holding the reference's parameters ``tree``."""
    model = Transformer(cfg, None, device=resolve_device(device))
    fill_module(model.embed, tree["embed"])
    fill_module(model.final_norm, tree["final_norm"])
    for blk, (key, period) in zip(model.layers, model.keys):
        fill_module(blk, _layer_tree(tree, key, period))
    if cfg.enc_layers:
        for i, blk in enumerate(model.encoder):
            fill_module(blk, _pick(tree["encoder"], i))
        fill_module(model.enc_norm, tree["enc_norm"])
    return model


def _module_tree(module):
    """A module's parameters as a nested dict keyed by name."""
    out: dict = {}
    for name, x in module.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = x
    return out


def params_to_tree(model: Transformer):
    """The port's parameters in the reference's tree layout (tensors on the
    model's device)."""
    out = _stacked_by_layer(model.keys, [_module_tree(b)
                                         for b in model.layers])
    out["embed"] = _module_tree(model.embed)
    out["final_norm"] = _module_tree(model.final_norm)
    if model.cfg.enc_layers:
        out["encoder"] = _stack([_module_tree(b) for b in model.encoder])
        out["enc_norm"] = _module_tree(model.enc_norm)
    return out


def cache_from_numpy(cfg, tree, device="cuda"):
    """The port's per-layer cache list from the reference's cache tree
    (bf16 leaves given as bf16 or as float32 arrays of bf16 values)."""
    dev = resolve_device(device)
    out = []
    for key, period in layer_keys(cfg):
        sub = _layer_tree(tree, key, period)
        out.append({name: {leaf: _tensor(v, dev).to(CACHE_DTYPES[leaf])
                           for leaf, v in d.items()}
                    for name, d in sub.items()})
    return out


def cache_to_tree(cfg, caches):
    """The reference's cache tree (stage-stacked periods, tail blocks) from
    the port's per-layer cache list, tensors where they lie."""
    return _stacked_by_layer(layer_keys(cfg), caches)


def cache_to_numpy(cfg, caches):
    """`cache_to_tree` on the host; bf16 leaves as float32 arrays."""
    def host(tree):
        if isinstance(tree, dict):
            return {n: host(v) for n, v in tree.items()}
        x = tree.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return host(cache_to_tree(cfg, caches))
