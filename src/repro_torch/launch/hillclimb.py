"""§Perf hillclimbs: hypothesis -> change -> re-count -> validate, logged.

The counterpart of ``repro/launch/hillclimb.py``, over the dry-run stand-in
(`launch.dryrun`) and the roofline (`launch.roofline`).  Each experiment
edits ONE knob (sharding rule or model tiling constant), re-runs the cell,
and records the three roofline terms before/after; the hypotheses are the
reference's, word for word, and each ``dominant_term_delta`` is logged as
it comes out.  They were written against XLA's compiled counts; the
stand-in counts the port's plain ops on ``meta``, so some need not hold:
the port's MoE dispatches by index (`models.moe`), not with the
reference's one-hot einsums, so qwen3's dispatch FLOPs do not scale with
the group size, and the port's attention has no ``attn_chunk`` knob.
Driven by a declared experiment list so the log is reproducible:

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell mamba2

(``--out`` defaults to ``artifacts/torch_perf_log.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from ..configs import get_config
from ..parallel.sharding import ShardingRules
from .dryrun import lower_cell
from .roofline import analyze_cell


def run_variant(arch, shape, *, rules=None, cfg_override=None, tag=""):
    rec = lower_cell(arch, shape, False, rules=rules,
                     cfg_override=cfg_override)
    cell = analyze_cell(tag, rec)
    return {
        "tag": tag,
        "compute_ms": cell["compute_ms"],
        "memory_ms": cell["memory_ms"],
        "collective_ms": cell["collective_ms"],
        "dominant": cell["dominant"],
        "useful_flops_ratio": cell["useful_flops_ratio"],
        "roofline_fraction": cell["roofline_fraction"],
        "mem_gib": cell["memory_gib"],
    }


# ---------------------------------------------------------------------------
# experiment definitions: (hypothesis, knob-apply fn)
# ---------------------------------------------------------------------------

def experiments_mamba2():
    """mamba2-1.3b train_4k — worst roofline fraction (memory-dominated).

    Dominant term: HBM bytes, driven by the SSD intra-chunk L/score tensors,
    whose traffic is b*S*h*q*4 bytes (linear in chunk size q)."""
    cfg = get_config("mamba2-1.3b")
    yield ("ssd_chunk 128->64: score traffic ~ S*q per head, so halving q "
           "should cut the SSD share of HBO bytes ~2x; FLOPs in the diagonal "
           "term also halve (q^2 * nc = S*q)",
           dict(cfg_override=dataclasses.replace(cfg, ssd_chunk=64),
                tag="ssd_chunk=64"))
    yield ("ssd_chunk 128->256: inverse control — traffic should grow ~2x",
           dict(cfg_override=dataclasses.replace(cfg, ssd_chunk=256),
                tag="ssd_chunk=256"))
    yield ("ssd_chunk 64 + state dim sharded over model axis is already "
           "active; try chunk 32 — expect diminishing returns as the "
           "inter-chunk state scan (S/q steps) and conv/proj bytes start to "
           "dominate",
           dict(cfg_override=dataclasses.replace(cfg, ssd_chunk=32),
                tag="ssd_chunk=32"))


def experiments_crplus():
    """command-r-plus-104b prefill_32k — most collective-bound cell.

    Dominant: per-layer TP all-reduces of (B,S,D) activations at S=32k."""
    cfg = get_config("command-r-plus-104b")
    yield ("sequence parallelism (seq->model on the residual stream): the "
           "2x all-reduce per layer becomes reduce-scatter + all-gather on "
           "1/16-size shards; expect collective bytes to drop toward ~1/2 "
           "and the norm/mlp memory term to shrink 16x on those segments",
           dict(rules=ShardingRules().with_overrides(
               seq="model", embed_act=None), tag="seq-parallel"))
    yield ("attn_chunk 1024->2048: fewer online-softmax passes means fewer "
           "re-reads of q (memory term), no collective change expected "
           "(control for term independence)",
           dict(cfg_override=dataclasses.replace(cfg, attn_chunk=2048),
                tag="attn_chunk=2048"))
    yield ("combine both winners",
           dict(rules=ShardingRules().with_overrides(seq="model"),
                cfg_override=dataclasses.replace(cfg, attn_chunk=2048),
                tag="seq-parallel+attn_chunk=2048"))


def experiments_qwen3():
    """qwen3-moe-30b-a3b train_4k — paper-representative cell (EP dispatch
    traffic is the fabric-sensitive collective the ESF engine models).

    MODEL/HLO = 0.63: ~30% of compiled FLOPs are dispatch/combine one-hot
    einsums, whose cost is T*E*C*d with C ∝ group_size."""
    cfg = get_config("qwen3-moe-30b-a3b")
    yield ("moe_group 512->256 halves capacity C hence dispatch/combine "
           "FLOPs ~2x on that term; expect compute_ms down ~15-25% and "
           "MODEL/HLO up",
           dict(cfg_override=dataclasses.replace(cfg, moe_group=256),
                tag="moe_group=256"))
    yield ("moe_group 256->128: same direction, diminishing because the "
           "expert FFN einsum now dominates; watch for capacity-drop risk "
           "(C=16 at tg=128) which the loss would pay, not the roofline",
           dict(cfg_override=dataclasses.replace(cfg, moe_group=128),
                tag="moe_group=128"))
    yield ("capacity_factor 1.25->1.0 at moe_group=256: C shrinks another "
           "20%; same-direction smaller effect",
           dict(cfg_override=dataclasses.replace(
               cfg, moe_group=256,
               moe=dataclasses.replace(cfg.moe, capacity_factor=1.0)),
               tag="moe_group=256+cf=1.0"))


CELLS = {
    "mamba2": ("mamba2-1.3b", "train_4k", experiments_mamba2),
    "crplus": ("command-r-plus-104b", "prefill_32k", experiments_crplus),
    "qwen3": ("qwen3-moe-30b-a3b", "train_4k", experiments_qwen3),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=tuple(CELLS) + ("all",), default="all")
    ap.add_argument("--out", default="artifacts/torch_perf_log.json")
    args = ap.parse_args(argv)

    log = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            log = json.load(f)

    for name, (arch, shape, gen) in CELLS.items():
        if args.cell not in ("all", name):
            continue
        print(f"=== hillclimb {name}: {arch} x {shape} ===", flush=True)
        entry = log.setdefault(name, {"arch": arch, "shape": shape,
                                      "iterations": []})
        base = run_variant(arch, shape, tag="baseline(paper-faithful)")
        print(json.dumps(base), flush=True)
        entry["baseline"] = base
        for hypothesis, kw in gen():
            tag = kw.pop("tag")
            print(f"--- {tag}: {hypothesis[:100]}...", flush=True)
            var = run_variant(arch, shape, tag=tag, **kw)
            dom = base["dominant"] + "_ms"
            delta = (var[dom] - base[dom]) / base[dom]
            var["hypothesis"] = hypothesis
            var["dominant_term_delta"] = round(delta, 4)
            print(json.dumps({k: var[k] for k in
                              ("tag", "compute_ms", "memory_ms",
                               "collective_ms", "dominant_term_delta")}),
                  flush=True)
            entry["iterations"].append(var)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(log, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
