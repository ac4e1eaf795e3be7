"""Multi-pod dry-run stand-in: size and count every (arch x shape x mesh) cell.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell's step for the 16x16 single-pod and 2x16x16 multi-pod meshes and
reads XLA's analyses.  The port has no compiler to ask, so nothing here is
compiled; each record has the reference's keys, computed as follows:

  * ``memory`` — ``argument_bytes`` and ``output_bytes`` are exact per
    device: every leaf's bytes divided by the mesh axes of its pruned spec
    (`parallel.sharding`), over the parameters, the AdamW state (train),
    the cache (the prefill's output, the decode step's argument) and the
    inputs, at the ``meta`` shapes of `models.model_zoo`.  An output the
    reference leaves unconstrained (the loss, the logits) counts
    replicated.  ``alias_bytes`` covers what the reference donates (the
    parameters and the AdamW state in train, the cache in decode).
    ``temp_bytes`` is None: ``peak_per_device_gib`` (arguments + outputs -
    aliases) is a lower bound;
  * ``flops_once`` and ``bytes_once`` — one `TorchDispatchMode` runs the
    step of `model_zoo.step_fn` on the ``meta`` device: for train the loss,
    its backward (with ``torch.utils.checkpoint``'s recompute of every
    layer) and the AdamW update, as the reference's step has them.  FLOPs
    are ``torch.utils.flop_counter``'s registered formulas (the matrix
    products and convolutions); bytes are the ``nbytes`` of every non-view
    aten op's inputs and outputs.  On ``meta`` the kernels' ops take their
    plain versions (the tensors are not on the card), so those are what is
    counted.  Both are for the whole step, divided by the devices that the
    pruned batch entry and the model axis split it over (a batch of 1
    splits over the model axis alone);
  * ``collectives_once`` — ``{kind: [count, per-device result bytes]}``,
    derived from the rules in force, with passes = 2 in train (forward and
    backward) and 1 otherwise:
      - each parameter leaf with a dim on "data" or "pod" (FSDP) is
        all-gathered once per forward and, in train, once more for the
        backward's recompute (its bytes times that dim's split), and in
        train its gradient is reduce-scattered (its per-device bytes);
      - each sublayer whose output projection has its input dim on
        "model" (attention's and cross attention's ``wo``, the MLP's
        ``wo``, the RG-LRU's ``w_o``, the SSD's ``out_proj``, an MoE's
        ``wo`` with its d_ff on "model") all-reduces its (B/dev, S, D) bf16
        output once a pass (S is 1 in decode);
      - where the pruned activation spec puts "seq" on "model" (sequence
        parallelism), each such all-reduce is a reduce-scatter (result
        1/model of it) plus an all-gather;
      - each MoE layer with its experts on "model" adds two all-to-alls a
        pass, each of its per-device dispatch buffer (tokens x D x E x
        capacity / group);
  * ``n_periods`` and no ``period``: the meta run executes every layer, so
    the reference's correction for a ``lax.scan`` body counted once does
    not apply, and `launch.roofline.corrected` adds nothing.
    ``with_period`` is accepted and ignored.

What the stand-in cannot give: XLA's temp bytes, the partitioner's own
collective schedule (it may gather, fuse or reorder otherwise), the
elementwise FLOPs and the fusion that ``cost_analysis`` reflects (its bytes
are those of the unfused plain ops), and the partial replication that the
partitioner leaves.  A cell's count is the same on both meshes and is made
once per process (`step_counts`).

Usage (``--out`` defaults to ``artifacts/torch_dryrun.json``):
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..models import model_zoo as zoo
from ..models import transformer as TF
from ..models.layers import DTYPE
from ..models.moe import capacity, groups
from ..optim import adamw
from ..parallel.sharding import (P, ShardingRules, _axis_size, logical,
                                 param_specs, prune_spec_for_shape,
                                 prune_tree_specs, set_mesh, tree_map,
                                 use_rules)
from .mesh import make_production_mesh

COLLECTIVE_RE = re.compile(
    r"(\w[\w.]*)\s*=\s*([a-z0-9]+)\[([\d,]*)\][^=]*?"
    r"\b(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")

DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
               "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
               "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}

FSDP_AXES = ("pod", "data")
# the output projections of the sublayers whose outputs are partial sums
# when their input dim lies on "model"
ROW_PARALLEL = ("attn.wo", "xattn.wo", "mlp.wo", "rglru.w_o", "ssd.out_proj")


def parse_collectives(hlo_text: str) -> dict:
    """op kind -> [count, total per-device result bytes] of compiled HLO
    text (kept for HLO a user pastes in; the stand-in derives its own)."""
    out: dict[str, list] = {}
    for m in COLLECTIVE_RE.finditer(hlo_text):
        _, dt, dims, kind = m.groups()
        nbytes = DTYPE_BYTES.get(dt, 4)
        for d in dims.split(","):
            if d:
                nbytes *= int(d)
        ent = out.setdefault(kind, [0, 0])
        ent[0] += 1
        ent[1] += nbytes
    return out


def batch_specs_for(cfg, shape, kind):
    b = logical("batch", None)
    if kind == "train":
        specs = {"tokens": b, "labels": b}
        if cfg.vision_patches or cfg.enc_layers:
            specs["frontend_embeds"] = logical("batch", None, "embed_act")
        return {"batch": specs}
    if kind == "prefill":
        out = {"tokens": b}
        if cfg.vision_patches or cfg.enc_layers:
            out["frontend_embeds"] = logical("batch", None, "embed_act")
        return out
    return {"tokens": b, "positions": b}


# ---------------------------------------------------------------------------
# per-device bytes
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def device_bytes(spec, t, mesh) -> int:
    """Bytes of ``t`` on one device under its (pruned) ``spec``."""
    n = t.numel() * t.element_size()
    for entry in spec:
        n //= _axis_size(mesh, entry)
    return n


def tree_bytes(specs, tree, mesh) -> int:
    return sum(_leaves(tree_map(lambda s, t: device_bytes(s, t, mesh),
                                specs, tree,
                                is_leaf=lambda x: isinstance(x, P))))


def _replicated(shape, dtype) -> int:
    n = dtype.itemsize
    for d in shape:
        n *= d
    return n


def abstract_param_specs(cfg, mesh):
    """(the ``meta`` parameters by name, their pruned specs) under the
    rules in scope."""
    params = dict(zoo.abstract_params(cfg).named_parameters())
    return params, prune_tree_specs(param_specs(TF.param_axes(cfg)), params,
                                    mesh)


def memory_record(cfg, shape, mesh, params, pspecs) -> dict:
    """The ``memory`` entry of a cell, under the mesh and rules in scope."""
    kind = shape.kind
    b, s = shape.global_batch, shape.seq_len
    inputs = zoo.input_specs(cfg, shape)
    bspecs = batch_specs_for(cfg, shape, kind)
    # prune batch shardings against the actual input shapes (e.g. the
    # long_500k global batch of 1 cannot shard over (pod, data))
    ins = inputs["batch"] if kind == "train" else inputs
    specs = bspecs["batch"] if kind == "train" else bspecs
    in_bytes = sum(device_bytes(prune_spec_for_shape(v, ins[k].shape, mesh),
                                ins[k], mesh) for k, v in specs.items())
    p_bytes = tree_bytes(pspecs, params, mesh)
    logits = _replicated((b, 1, cfg.vocab), DTYPE)
    if kind == "train":
        opt = adamw.init(params)
        ospecs = prune_tree_specs(adamw.state_axes(pspecs), opt, mesh)
        o_bytes = tree_bytes(ospecs, opt, mesh)
        arg, out = p_bytes + o_bytes + in_bytes, p_bytes + o_bytes + 4
        alias = p_bytes + o_bytes
    else:
        cache = zoo.abstract_cache(cfg, b, s) if kind == "prefill" \
            else inputs["cache"]
        cspecs = prune_tree_specs(param_specs(TF.cache_axes(cfg)), cache,
                                  mesh)
        c_bytes = tree_bytes(cspecs, cache, mesh)
        out = logits + c_bytes
        if kind == "prefill":
            arg, alias = p_bytes + in_bytes, 0
        else:
            arg, alias = p_bytes + c_bytes + in_bytes, c_bytes
    return {"argument_bytes": arg, "output_bytes": out, "temp_bytes": None,
            "alias_bytes": alias,
            "peak_per_device_gib": round((arg + out - alias) / 2**30, 3)}


# ---------------------------------------------------------------------------
# FLOPs and bytes of the step, on the meta device
# ---------------------------------------------------------------------------

class CountMode(TorchDispatchMode):
    """FLOPs (``flop_counter``'s formulas) and bytes (inputs and outputs of
    every non-view op) of the aten ops run under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


_COUNTS: dict = {}


def step_counts(cfg, shape) -> tuple[int, int]:
    """(FLOPs, bytes) of the whole step of a cell on the ``meta`` device;
    made once per (config, shape) in a process."""
    key = (cfg, shape.name)
    if key in _COUNTS:
        return _COUNTS[key]
    model = zoo.abstract_params(cfg)
    inputs = zoo.input_specs(cfg, shape)
    step = zoo.step_fn(cfg, shape.kind)
    mode = CountMode()
    if shape.kind == "train":
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        opt = adamw.init(params)
        with mode:
            loss, _ = step(model, inputs["batch"])
            loss.backward()
            adamw.update(opt, {n: p.grad for n, p in params.items()},
                         params, lr=1e-4)
    elif shape.kind == "prefill":
        with mode:
            step(model, inputs["tokens"], inputs["max_len"],
                 frontend_embeds=inputs.get("frontend_embeds"))
    else:
        with mode:
            step(model, inputs["cache"], inputs["tokens"],
                 inputs["positions"])
    _COUNTS[key] = (mode.flops, mode.bytes)
    return _COUNTS[key]


# ---------------------------------------------------------------------------
# collectives from the rules in force
# ---------------------------------------------------------------------------

def _on(entry, names) -> bool:
    if entry is None:
        return False
    return any(a in names for a in (entry if isinstance(entry, (tuple, list))
                                    else (entry,)))


def _add(out, kind, count, nbytes):
    ent = out.setdefault(kind, [0, 0])
    ent[0] += count
    ent[1] += count * nbytes


def collectives_record(cfg, shape, mesh, params, pspecs) -> dict:
    """``collectives_once`` of a cell under the mesh and rules in scope
    (the rules are in the module docstring)."""
    train = shape.kind == "train"
    passes = 2 if train else 1
    out: dict[str, list] = {}
    for name, spec in pspecs.items():
        split = 1
        for entry in spec:
            if _on(entry, FSDP_AXES):
                split *= _axis_size(mesh, entry)
        if split > 1:
            nbytes = device_bytes(spec, params[name], mesh)
            _add(out, "all-gather", passes, nbytes * split)
            if train:
                _add(out, "reduce-scatter", 1, nbytes)

    b, d = shape.global_batch, cfg.d_model
    s = 1 if shape.kind in ("decode", "long_decode") else shape.seq_len

    def activation_out(rows):
        """One row-parallel sublayer's (B/dev, rows, D) bf16 output."""
        spec = prune_spec_for_shape(logical("batch", "seq", "embed_act"),
                                    (b, rows, d), mesh)
        full = _replicated((b, rows, d), DTYPE) // _axis_size(mesh, spec[0])
        if _on(spec[1], ("model",)):
            _add(out, "reduce-scatter", passes,
                 full // _axis_size(mesh, spec[1]))
            _add(out, "all-gather", passes, full)
        else:
            _add(out, "all-reduce", passes, full)

    def row_parallel(name, dim=0):
        return _on(pspecs[name][dim], ("model",))

    layers = [(f"layers.{i}.", key.split("_", 1)[1], s)
              for i, (key, _) in enumerate(TF.layer_keys(cfg))]
    layers += [(f"encoder.{i}.", "attn", cfg.enc_frames)
               for i in range(cfg.enc_layers)]
    for prefix, kind, rows in layers:
        for sub in ROW_PARALLEL:
            if prefix + sub in pspecs and row_parallel(prefix + sub):
                activation_out(rows)
        if kind == "attn_moe":
            wo = prefix + "moe.wo"
            if row_parallel(wo, 1):
                activation_out(rows)
            if row_parallel(wo, 0):
                e = cfg.moe.n_experts
                _, tg = groups(b * rows, cfg.moe_group)
                cap = capacity(cfg.moe.top_k, tg, e, cfg.moe.capacity_factor)
                spec = prune_spec_for_shape(logical("batch", None),
                                            (b, rows), mesh)
                tokens = b * rows // _axis_size(mesh, spec[0])
                _add(out, "all-to-all", 2 * passes,
                     tokens * d * 2 * e * cap // tg)
    return out


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               rules: ShardingRules | None = None,
               with_period: bool = True, cfg_override=None) -> dict:
    """The record of one cell (see the module docstring); ``with_period``
    is accepted for the reference's signature and ignored."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rules or ShardingRules()
    t0 = time.time()
    with set_mesh(mesh), use_rules(rules):
        params, pspecs = abstract_param_specs(cfg, mesh)
        rec["memory"] = memory_record(cfg, shape, mesh, params, pspecs)
        bspec = prune_spec_for_shape(logical("batch", None),
                                     (shape.global_batch, shape.seq_len),
                                     mesh)
        split = _axis_size(mesh, bspec[0]) * mesh.shape["model"]
        flops, nbytes = step_counts(cfg, shape)
        rec["flops_once"] = flops / split
        rec["bytes_once"] = nbytes / split
        rec["collectives_once"] = collectives_record(cfg, shape, mesh,
                                                     params, pspecs)
        rec["n_periods"] = cfg.n_periods
        rec["lower_s"] = round(time.time() - t0, 2)
        rec["compile_s"] = None
        rec["status"] = "ok"
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/torch_dryrun.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-period", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mp in (False, True):
                    cells.append((arch, shape, mp))
    else:
        cells.append((args.arch, args.shape, args.multi_pod))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    for arch, shape, mp in cells:
        key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
        if key in results and results[key].get("status") in ("ok", "skipped") \
                and not args.force:
            print(f"[skip cached] {key}")
            continue
        print(f"[dryrun] {key}", flush=True)
        try:
            rec = lower_cell(arch, shape, mp, with_period=not args.no_period)
        except Exception as e:  # noqa: BLE001
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16",
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        results[key] = rec
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        mem = rec.get("memory", {}).get("peak_per_device_gib", "-")
        print(f"  -> {rec.get('status')} (peak/device >= {mem} GiB, "
              f"host {rec.get('lower_s', '-')}s)", flush=True)

    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_skip = sum(1 for r in results.values() if r.get("status") == "skipped")
    n_err = sum(1 for r in results.values() if r.get("status") == "error")
    print(f"dryrun summary: ok={n_ok} skipped={n_skip} error={n_err}")
    if n_err:
        for k, r in results.items():
            if r.get("status") == "error":
                print(f"  ERROR {k}: {r['error']}")


if __name__ == "__main__":
    main()
