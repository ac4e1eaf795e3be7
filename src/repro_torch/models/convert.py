"""Carry the reference's parameters and caches across to the port.

The counterpart, for the model stack, of `core.convert` for lowered tables.
The reference's parameter pytree (``repro.models.transformer.init_params``)
and cache pytree (``prefill`` / ``init_cache``) arrive as nested dicts of
numpy arrays.  Periods are stacked on a leading stage axis there, keyed
``b{i}_{kind}``; tail blocks are keyed ``t{i}_{kind}`` and have no stage
axis.  The port keeps one module, and one cache dict, per layer, in the
same order (`transformer.layer_keys`).

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


def _layer_tree(tree, key, period):
    """One layer's subtree: the stage slice of a period block, or a tail
    block as it is."""
    if period is None:
        return tree["tail"][key]

    def pick(sub):
        return {n: pick(v) if isinstance(v, dict) else np.asarray(v)[period]
                for n, v in sub.items()}
    return pick(tree["stages"][key])


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
    return model


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


def cache_to_numpy(cfg, caches):
    """The reference's cache tree (stage-stacked periods, tail blocks) from
    the port's per-layer cache list; bf16 leaves as float32 arrays."""
    def host(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    stages: dict = {}
    tail: dict = {}
    for (key, period), layer in zip(layer_keys(cfg), caches):
        host_layer = {name: {leaf: host(v) for leaf, v in d.items()}
                      for name, d in layer.items()}
        if period is None:
            tail[key] = host_layer
        else:
            stages.setdefault(key, []).append(host_layer)
    out = {"stages": {
        key: {name: {leaf: np.stack([p[name][leaf] for p in per])
                     for leaf in per[0][name]}
              for name in per[0]}
        for key, per in stages.items()}}
    if tail:
        out["tail"] = tail
    return out
