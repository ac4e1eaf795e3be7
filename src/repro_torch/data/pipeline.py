"""Deterministic synthetic LM data pipeline (stateless, elastic-friendly).

The counterpart of ``repro/data/pipeline.py``.  Batches are pure functions
of (seed, step, shard), so any host can produce its shard for any step —
resuming from a checkpoint needs no data-loader state.  The generator
mixes a Markov babble source (so the LM has learnable structure: loss drops
well below log(vocab)) with the ESF trace-replay source (the port's
`core.traces`, whose arrays equal the reference's).

Both sources are numpy, drawn exactly as the reference draws them, so their
tokens equal the reference's bit for bit; `batch(step)` hands them over as
int32 CPU tensors (the trainer moves them to its device).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 1          # Markov order of the synthetic source


def _markov_table(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed + 1)
    t = rng.dirichlet(np.full(min(cfg.vocab, 256), 0.05),
                      size=min(cfg.vocab, 256))
    return t


def _batch(tokens: np.ndarray) -> dict:
    t = torch.from_numpy(tokens.astype(np.int32))
    return {"tokens": t, "labels": t}


class SyntheticLM:
    """Markov-chain token stream; `batch(step)` -> host-local shard."""

    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.table = _markov_table(cfg)
        self.eff_vocab = self.table.shape[0]
        if cfg.global_batch % n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {n_shards} shards")
        self.local_batch = cfg.global_batch // n_shards

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.cfg.seed, step, self.shard, 0xE5F))
        b, s = self.local_batch, self.cfg.seq_len
        toks = np.empty((b, s), np.int64)
        toks[:, 0] = rng.integers(0, self.eff_vocab, b)
        u = rng.random((b, s))
        cum = np.cumsum(self.table, axis=1)
        for t in range(1, s):
            toks[:, t] = (u[:, t:t + 1] <
                          cum[toks[:, t - 1]]).argmax(axis=1)
        return _batch(toks)


class TraceLM:
    """ESF trace-replay source: workload memory traces tokenized as
    (address-delta bucket, r/w) events — systems data through the same API."""

    def __init__(self, cfg: DataConfig, workload: str = "silo",
                 shard: int = 0, n_shards: int = 1):
        from ..core import traces as TR

        self.cfg = cfg
        self.local_batch = cfg.global_batch // n_shards
        tr = TR.generate(workload, n=200_000, seed=cfg.seed + shard)
        delta = np.diff(tr["addr"], prepend=tr["addr"][0])
        bucket = np.clip(np.abs(delta), 0, cfg.vocab // 2 - 1)
        self.stream = (bucket * 2 + tr["is_write"]).astype(np.int64) \
            % cfg.vocab

    def batch(self, step: int) -> dict:
        b, s = self.local_batch, self.cfg.seq_len
        n = len(self.stream)
        idx = (np.arange(b)[:, None] * 9973 + step * b * s
               + np.arange(s)[None]) % (n - 1)
        return _batch(self.stream[idx])


def make_source(kind: str, cfg: DataConfig, **kw):
    return {"synthetic": SyntheticLM, "trace": TraceLM}[kind](cfg, **kw)
