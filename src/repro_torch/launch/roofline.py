"""Roofline analysis from the dry-run records (single-pod table).

The counterpart of ``repro/launch/roofline.py``, over the dry-run stand-in
(`launch.dryrun`).  Three terms per (arch x shape):

  compute    = FLOPs_dev / peak_FLOPs
  memory     = bytes_dev / HBM_bw
  collective = coll_bytes_dev / link_bw

with the reference's scan-body trip-count correction (`corrected`: total =
once + (n_periods-1) x period), which adds nothing for the stand-in's
records: they carry no ``period``, since the meta run counts every layer.
MODEL_FLOPS = 6*N*D (train) / 2*N_active*D (prefill, decode); the ratio
MODEL/counted exposes recompute and padding waste.  The ESF fabric engine
independently predicts the dominant collective (`fabric_crosscheck`, each
collective resolved by `core.fabric_model.predict_collective`, on the card
through the fused serve round unless the CPU is asked for).

The rates are the simulated v5e pod's parameters from `core.fabric_model`
(197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s per ICI link), not the rates of
the card the port runs on: the table answers the reference's question, how
the cells would fare on that pod.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline \\
           [--dryrun artifacts/torch_dryrun.json] \\
           [--out artifacts/torch_roofline.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

from ..configs import ARCH_IDS, SHAPES, get_config
from ..core.fabric_model import V5E_HBM_BPS, V5E_ICI_MBPS, V5E_PEAK_FLOPS
from .mesh import make_production_mesh

PEAK_FLOPS = V5E_PEAK_FLOPS
HBM_BW = V5E_HBM_BPS
ICI_LINK = V5E_ICI_MBPS * 1e6
CHIPS = make_production_mesh().size


def model_flops_global(cfg, shape) -> float:
    n_act = cfg.active_params_count()
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch  # one token per sequence


def corrected(rec: dict) -> dict:
    np_ = rec.get("n_periods", 1)
    flops = rec["flops_once"]
    nbytes = rec["bytes_once"]
    colls = {k: list(v) for k, v in rec["collectives_once"].items()}
    per = rec.get("period")
    if per and np_ > 1:
        flops += (np_ - 1) * per["flops"]
        nbytes += (np_ - 1) * per["bytes"]
        for k, (c, b) in per["collectives"].items():
            ent = colls.setdefault(k, [0, 0])
            ent[0] += (np_ - 1) * c
            ent[1] += (np_ - 1) * b
    return {"flops_dev": flops, "bytes_dev": nbytes, "collectives": colls}


def analyze_cell(key: str, rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    c = corrected(rec)
    coll_bytes = sum(b for _, b in c["collectives"].values())
    terms = {
        "compute_s": c["flops_dev"] / PEAK_FLOPS,
        "memory_s": c["bytes_dev"] / HBM_BW,
        "collective_s": coll_bytes / ICI_LINK,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops_global(cfg, shape) / CHIPS
    bound_s = max(terms.values())
    # useful work: compute OR the unavoidable HBM stream (params + caches =
    # the step's argument bytes), whichever is larger — decode steps are
    # legitimately bandwidth-rooflined, not FLOP-rooflined
    min_stream_s = rec["memory"]["argument_bytes"] / HBM_BW
    useful_s = max(mf / PEAK_FLOPS, min_stream_s)
    out = {
        "arch": rec["arch"], "shape": rec["shape"],
        **{k: round(v * 1e3, 3) for k, v in
           {"compute_ms": terms["compute_s"],
            "memory_ms": terms["memory_s"],
            "collective_ms": terms["collective_s"]}.items()},
        "dominant": dominant.replace("_s", ""),
        "model_flops_dev": mf,
        "hlo_flops_dev": c["flops_dev"],
        "useful_flops_ratio": round(mf / max(c["flops_dev"], 1), 3),
        "roofline_fraction": round(useful_s / max(bound_s, 1e-12), 3),
        "collective_bytes_dev": coll_bytes,
        "collectives": c["collectives"],
        "memory_gib": rec["memory"]["peak_per_device_gib"],
        "note": _note(dominant, rec, cfg, shape),
    }
    return out


def _note(dominant: str, rec, cfg, shape) -> str:
    if dominant == "compute_s":
        return ("compute-bound: raise MFU via fused attention kernels and "
                "less recompute (remat policy)")
    if dominant == "memory_s":
        if shape.kind in ("decode", "long_decode"):
            return ("HBM-bound decode: weights+KV stream per token; shrink "
                    "via KV sharding/quantization or larger batch")
        return ("HBM-bound: fuse ops to cut activation traffic; check CPU "
                "bf16-emulation inflation (DESIGN.md)")
    return ("collective-bound: re-span sharding axes (autotuner), overlap "
            "gathers with compute, or compress cross-pod gradients")


def fabric_crosscheck(cells: list[dict], top_n: int = 3,
                      device=None) -> list[dict]:
    """ESF-engine prediction for the most collective-bound cells, each
    collective's schedule resolved on ``device`` (the card by default)."""
    from ..core.fabric_model import TPUFabric, predict_collective

    fab = TPUFabric(16, 16)
    graph = fab.build()
    worst = sorted((c for c in cells if c), key=lambda c: -c["collective_ms"])
    out = []
    for c in worst[:top_n]:
        per_kind = {}
        for kind, (cnt, nbytes) in c["collectives"].items():
            op = {"all-gather": "all_gather", "all-reduce": "all_reduce",
                  "reduce-scatter": "reduce_scatter",
                  "all-to-all": "all_to_all"}.get(kind)
            if op is None or nbytes == 0 or cnt == 0:
                continue
            mean = int(nbytes) // int(cnt)
            est = predict_collective(fab, graph, op, "y", mean,
                                     device="cuda" if device is None
                                     else device)
            per_kind[kind] = {"hlo_bytes": nbytes, "n_ops": cnt,
                              "esf_pred_ms": round(est.seconds * cnt * 1e3, 3)}
        out.append({"arch": c["arch"], "shape": c["shape"],
                    "alpha_beta_ms": c["collective_ms"],
                    "esf_engine": per_kind})
    return out


def render_table(cells: list[dict]) -> str:
    hdr = ("| arch | shape | compute ms | memory ms | collective ms | "
           "dominant | MODEL/HLO | roofline frac | mem GiB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|")
    rows = [hdr]
    for c in cells:
        if not c:
            continue
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['compute_ms']} | "
            f"{c['memory_ms']} | {c['collective_ms']} | {c['dominant']} | "
            f"{c['useful_flops_ratio']} | {c['roofline_fraction']} | "
            f"{c['memory_gib']} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="artifacts/torch_dryrun.json")
    ap.add_argument("--out", default="artifacts/torch_roofline.json")
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with open(args.dryrun) as f:
        recs = json.load(f)
    cells = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            key = f"{arch}|{shape}|{args.mesh}"
            if key in recs:
                cells.append(analyze_cell(key, recs[key]))
    live = [c for c in cells if c]
    cross = fabric_crosscheck(live, device=args.device)
    with open(args.out, "w") as f:
        json.dump({"cells": live, "fabric_crosscheck": cross}, f, indent=1)
    print(render_table(live))
    print("\nESF fabric cross-check (most collective-bound cells):")
    print(json.dumps(cross, indent=1))
    print(f"\nwrote {args.out} ({len(live)} cells)")


if __name__ == "__main__":
    main()
