"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps.

The counterpart of ``examples/train_small_lm.py``, on the port, with
``--device`` (the card by default):

    PYTHONPATH=src python -m repro_torch.studies.train_small_lm [--steps 300]
    PYTHONPATH=src python -m repro_torch.studies.train_small_lm \
        --preset smoke --steps 20 --device cpu

Exercises the substrate: the train step (flash attention and its backward
kernel on the card), AdamW with float32 master weights, the warmup-cosine
schedule, async atomic checkpoints and auto-resume (kill it mid-run and
re-launch), straggler detection, stateless data.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from ..launch import train as T


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", default="100m", choices=("smoke", "100m"))
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_100m_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return T.main([
        "--arch", "llama3-8b", "--preset", args.preset,
        "--steps", str(args.steps), "--batch", "8",
        "--seq", "256" if args.preset == "100m" else "64",
        "--lr", "1e-3", "--ckpt-dir", args.ckpt_dir,
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
