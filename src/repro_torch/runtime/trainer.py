"""Trainer: the train step, microbatching, checkpoints, metrics.

The counterpart of ``repro/runtime/trainer.py`` on one card.  A step runs
`transformer.loss_fn` forward and backward once per microbatch (the batch
split along its first axis, as the reference's ``lax.scan`` splits it),
accumulates the float32 gradients divided by the microbatch count, takes
the learning rate from the schedule at the optimizer's step and applies
`optim.adamw.update`; its metrics are the reference's: ``loss`` and
``xent`` (means over the microbatches), ``lr`` and ``grad_norm``.  With one
microbatch no float32 copy of the gradients is made: `adamw.update` casts
each leaf as it goes, which gives the same numbers (``g.astype(f32) / 1``
is exact).  Around the step: checkpoint save and auto-resume (atomic,
async), straggler detection (`runtime.straggler`).

Differences from the reference, each for one card:
  * the mesh (`launch.mesh`), ``ShardingRules``, ``set_mesh`` and
    ``param_specs`` (`parallel.sharding`) have their counterparts, but one
    card still shards nothing: the trainer takes no mesh, the model and the
    optimizer state live whole on ``device``, and nothing is sharded or
    donated (``tree_as_shardings`` has none);
  * ``jax.jit`` has none either: the step runs eagerly, its kernels
    launched one by one;
  * the parameters are the model's own tensors, updated in place, so
    `fit` returns the same model object it trained;
  * a periodic checkpoint is labelled with the number of steps done
    (``step + 1``), so that resuming from it runs the next step; the
    reference labels it with the index of the step just done, and resuming
    from such a checkpoint would run that step again.  The final one is
    ``steps`` in both.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..checkpoint import checkpoint as ckpt
from ..core.engine import resolve_device
from ..models import transformer as TF
from ..optim import adamw, schedules
from .straggler import StragglerDetector


@dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    peak_lr: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    ckpt_dir: str = ""
    ckpt_every: int = 200
    async_ckpt: bool = True
    log_every: int = 10
    schedule: str = "warmup_cosine"


class Trainer:
    def __init__(self, cfg, train_cfg: TrainConfig, *, device="cuda"):
        self.cfg = cfg
        self.tc = train_cfg
        self.device = resolve_device(device)
        self.detector = StragglerDetector()
        self.metrics_log: list[dict] = []
        self.sched_fn = getattr(schedules, train_cfg.schedule)

    # ------------------------------------------------------------------
    def step_fn(self, params, opt_state, batch):
        """One train step on ``batch`` (dict of (B, ...) tensors): returns
        (params, new optimizer state, metrics as float32 scalars on the
        device).  ``params`` is the model; it is updated in place."""
        tc, mb = self.tc, self.tc.microbatches
        named = dict(params.named_parameters())
        batch = {k: v.to(self.device) for k, v in batch.items()}
        n = next(iter(batch.values())).shape[0]
        if n % mb:
            raise ValueError(f"batch of {n} rows does not split into {mb} "
                             f"microbatches")
        rows = n // mb
        acc = None
        losses, xents = [], []
        for i in range(mb):
            part = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            for p in named.values():
                p.grad = None
            loss, metrics = TF.loss_fn(params, part)
            loss.backward()
            losses.append(loss.detach())
            xents.append(metrics["xent"].detach())
            if mb > 1:
                if acc is None:
                    acc = {k: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                           for k, p in named.items()}
                for k, p in named.items():
                    acc[k] += p.grad.float() / mb
        grads = acc if mb > 1 else {k: p.grad for k, p in named.items()}
        lr = self.sched_fn(opt_state.step, peak_lr=tc.peak_lr,
                           warmup_steps=tc.warmup_steps,
                           total_steps=tc.steps)
        _, opt_state, om = adamw.update(
            opt_state, grads, named, lr=lr, weight_decay=tc.weight_decay,
            grad_clip=tc.grad_clip)
        del grads, acc
        for p in named.values():
            p.grad = None
        return params, opt_state, {
            "loss": torch.stack(losses).mean(),
            "xent": torch.stack(xents).mean(), "lr": lr, **om}

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """(model, AdamW state): weights drawn from a ``torch.Generator``
        seeded with ``seed`` on the trainer's device, gradients on."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = TF.init_params(self.cfg, gen, device=self.device)
        params.requires_grad_(True)
        return params, adamw.init(dict(params.named_parameters()))

    def maybe_resume(self, params, opt_state):
        if not self.tc.ckpt_dir:
            return params, opt_state, 0
        step = ckpt.latest_step(self.tc.ckpt_dir)
        if step is None:
            return params, opt_state, 0
        (params, opt_state), step = ckpt.restore(
            self.tc.ckpt_dir, (params, opt_state))
        return params, opt_state, step

    # ------------------------------------------------------------------
    def fit(self, source, params=None, opt_state=None, start_step: int = 0):
        if params is None:
            params, opt_state = self.init_state()
            params, opt_state, start_step = self.maybe_resume(params,
                                                              opt_state)
        tc = self.tc
        for step in range(start_step, tc.steps):
            batch = source.batch(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            verdict = self.detector.observe(0, dt)
            metrics.update(step=step, step_time_s=dt, straggler=verdict)
            self.metrics_log.append(metrics)
            if step % tc.log_every == 0:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"lr {metrics['lr']:.2e} {dt * 1e3:.0f} ms",
                      flush=True)
            if tc.ckpt_dir and step + 1 < tc.steps \
                    and (step + 1) % tc.ckpt_every == 0:
                ckpt.save(tc.ckpt_dir, step + 1, (params, opt_state),
                          blocking=not tc.async_ckpt)
        if tc.ckpt_dir:
            ckpt.save(tc.ckpt_dir, tc.steps, (params, opt_state))
        return params, opt_state
