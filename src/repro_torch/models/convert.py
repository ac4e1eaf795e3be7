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

Training state crosses too: `grads_to_tree` lays the parameters' gradients
out as the reference's gradient pytree, and `adamw_from_numpy` /
`adamw_to_numpy` carry the reference's ``AdamWState`` (``step``, and ``m``,
``v`` and ``master`` as parameter trees) to the port's `optim.adamw.AdamWState`
(the same leaves keyed by parameter name) and back.

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
from .transformer import Transformer, _leaves, layer_keys

# the dtype of each cache leaf (as `transformer.init_cache` makes them)
CACHE_DTYPES = {"k": DTYPE, "v": DTYPE, "len": torch.int32, "conv": DTYPE,
                "h": torch.float32}


def _tensor(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


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


def _module_tree(module, values=None, prefix=""):
    """``values`` of a module's parameters (keyed by their names in the
    whole model, under ``prefix``; the parameters themselves by default) as
    a nested dict keyed by name."""
    if values is None:
        values = dict(module.named_parameters())
    out: dict = {}
    for name, _ in module.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = values[prefix + name]
    return out


def named_to_tree(model: Transformer, values: dict):
    """One tensor per parameter (``values``, keyed as
    ``model.named_parameters()``) in the reference's tree layout."""
    out = _stacked_by_layer(model.keys, [
        _module_tree(b, values, f"layers.{i}.")
        for i, b in enumerate(model.layers)])
    out["embed"] = _module_tree(model.embed, values, "embed.")
    out["final_norm"] = _module_tree(model.final_norm, values, "final_norm.")
    if model.cfg.enc_layers:
        out["encoder"] = _stack([_module_tree(b, values, f"encoder.{i}.")
                                 for i, b in enumerate(model.encoder)])
        out["enc_norm"] = _module_tree(model.enc_norm, values, "enc_norm.")
    return out


def params_to_tree(model: Transformer):
    """The port's parameters in the reference's tree layout (tensors on the
    model's device)."""
    return named_to_tree(model, dict(model.named_parameters()))


def grads_to_tree(model: Transformer):
    """The parameters' gradients (``.grad``, in each parameter's dtype) in
    the reference's tree layout, to compare leaf for leaf with the
    reference's gradient pytree; a parameter without a gradient is an
    error."""
    grads = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            raise ValueError(f"{name} has no gradient")
        grads[name] = p.grad
    return named_to_tree(model, grads)


def tree_to_named(model: Transformer, tree, device=None) -> dict:
    """The reference's parameter-shaped tree as one tensor per parameter
    name (the inverse of `named_to_tree`), each on ``device`` (the model's
    by default) in the leaf's own dtype."""
    dev = model.device if device is None else resolve_device(device)
    out = {}

    def take(prefix, sub):
        for path, value in _leaves(sub):
            out[prefix + path] = _tensor(value, dev)

    for i, (key, period) in enumerate(model.keys):
        take(f"layers.{i}.", _layer_tree(tree, key, period))
    take("embed.", tree["embed"])
    take("final_norm.", tree["final_norm"])
    if model.cfg.enc_layers:
        for i in range(model.cfg.enc_layers):
            take(f"encoder.{i}.", _pick(tree["encoder"], i))
        take("enc_norm.", tree["enc_norm"])
    missing = sorted(set(n for n, _ in model.named_parameters()) - set(out))
    if missing:
        raise ValueError(f"reference tree lacks parameters {missing}")
    return out


def adamw_from_numpy(model: Transformer, state, device=None):
    """The port's `optim.adamw.AdamWState` holding the reference's
    ``AdamWState`` ``state`` (leaves as numpy arrays)."""
    from ..optim.adamw import AdamWState

    dev = model.device if device is None else resolve_device(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        m=tree_to_named(model, state.m, dev),
        v=tree_to_named(model, state.v, dev),
        master=tree_to_named(model, state.master, dev))


def adamw_to_numpy(model: Transformer, state) -> dict:
    """The port's AdamW state as the reference's fields: ``step`` an int,
    ``m``, ``v`` and ``master`` float32 numpy trees in the reference's
    layout."""
    def host(tree):
        if isinstance(tree, dict):
            return {n: host(v) for n, v in tree.items()}
        return tree.detach().cpu().numpy()

    return {"step": int(state.step),
            **{f: host(named_to_tree(model, getattr(state, f)))
               for f in ("m", "v", "master")}}


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
