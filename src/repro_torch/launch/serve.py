"""Serving CLI: batched decode over a slot pool.

The counterpart of ``repro/launch/serve.py``, with the same flags plus
``--device``.  It serves the architecture's smoke config with weights drawn
from a seeded generator, on the card by default:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --device cpu

It runs for every architecture the reference's launcher runs: whisper-base
is refused (`runtime.server.Server` takes no encoder-decoder model; the
reference's launcher fails on it at the first prefill).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_smoke_config
from ..core.engine import resolve_device
from ..models import transformer as TF
from ..runtime.server import Request, Server


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = TF.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        int(rng.integers(4, 16)))
                    .astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    srv = Server(model, slots=args.slots, max_len=args.max_len,
                 temperature=args.temperature)
    t0 = time.perf_counter()
    stats = srv.run(reqs)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"arch={cfg.name} served {len(reqs)} reqs, "
          f"{stats['generated']} tokens in {stats['ticks']} ticks "
          f"({dt:.1f}s, {stats['generated'] / dt:.1f} tok/s on {where})")


if __name__ == "__main__":
    main()
