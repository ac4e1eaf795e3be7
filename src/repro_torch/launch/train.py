"""End-to-end training driver.

The counterpart of ``repro/launch/train.py``, with its flags plus
``--device`` (the card by default):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --preset smoke --steps 200 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --preset smoke \
        --device cpu

Presets: smoke (per-arch reduced config), 100m (a ~100M-param llama-style
config for the end-to-end example), full (the assigned config).  It trains
on one device: ``--model-par`` above 1 is refused (`launch.mesh.
make_host_mesh` builds the reference's host mesh, but one card still
shards nothing), and the line the reference prints with its mesh names the
device instead.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..configs.base import ArchConfig
from ..core.engine import resolve_device
from ..data.pipeline import DataConfig, make_source
from ..runtime.trainer import TrainConfig, Trainer

PRESET_100M = ArchConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv=4, d_ff=2048, vocab=32768, head_dim=64, max_seq=2048)


def pick_config(arch: str, preset: str) -> ArchConfig:
    if preset == "100m":
        return PRESET_100M
    if preset == "smoke":
        return get_smoke_config(arch)
    return get_config(arch)


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3-8b")
    ap.add_argument("--preset", choices=("smoke", "100m", "full"),
                    default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--data", choices=("synthetic", "trace"),
                    default="synthetic")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model_par != 1:
        ap.error(f"--model-par {args.model_par}: the port trains on one "
                 f"device, with no model-parallel mesh")

    dev = resolve_device(args.device)
    cfg = pick_config(args.arch, args.preset)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} params~{cfg.params_count() / 1e6:.1f}M "
          f"device={where}")

    tc = TrainConfig(steps=args.steps, microbatches=args.microbatches,
                     peak_lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                     ckpt_dir=args.ckpt_dir, log_every=10)
    trainer = Trainer(cfg, tc, device=dev)
    source = make_source(args.data, DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    trainer.fit(source)
    losses = [m["loss"] for m in trainer.metrics_log]
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
          f"steps={len(losses)}")
    return trainer


if __name__ == "__main__":
    main()
