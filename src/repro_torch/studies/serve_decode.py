"""Batched serving example: continuous batching over a slot pool, on the
port.

The counterpart of ``examples/serve_decode.py``: recurrentgemma-2b's smoke
config (hybrid: ring-buffer attention and RG-LRU caches) behind the slot
`Server`, six greedy requests over three slots.  Its prefills run the
flash-attention and RG-LRU scan kernels, on the card by default.  The
weights are drawn from a torch generator seeded with ``--seed``, or passed
in (``main(model=...)``, e.g. the reference's weights carried across by
`models.convert`):

    PYTHONPATH=src python -m repro_torch.studies.serve_decode [--device cpu] [--seed 0]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_smoke_config
from ..core.engine import resolve_device
from ..models import transformer as TF
from ..runtime.server import Request, Server

ARCH = "recurrentgemma-2b"


def make_requests(vocab: int) -> list[Request]:
    """The example's six requests: prompts of 4 to 11 tokens, 8 new each."""
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, int(rng.integers(4, 12)))
                    .astype(np.int32),
                    max_new=8)
            for i in range(6)]


def main(device="cuda", seed: int = 0, model=None):
    """Serve the six requests and print what the example prints; returns
    the requests (with their tokens), the server's stats and the model."""
    cfg = get_smoke_config(ARCH)
    if model is None:
        dev = resolve_device(device)
        model = TF.init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed), device=dev)
    requests = make_requests(cfg.vocab)
    srv = Server(model, slots=3, max_len=64, temperature=0.0)
    stats = srv.run(requests)
    print(f"served {len(requests)} requests in {stats['ticks']} decode ticks "
          f"({stats['generated']} tokens) on {srv.slots} slots")
    for r in requests:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
    return requests, stats, model


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    main(args.device, args.seed)
