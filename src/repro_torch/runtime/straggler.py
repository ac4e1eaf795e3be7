"""Straggler detection + mitigation policy (fabric-model-informed), on the
port: the counterpart of ``repro.runtime.straggler``.

Detection: per-step wall times feed an EWMA + k*sigma detector; sustained
outliers flag a straggling worker/link.  Mitigation escalates:

  1. "rebalance"  — shrink the straggler's data shard (gradient weighting
                    keeps the estimator unbiased);
  2. "checkpoint_evict" — checkpoint, drop the slow host, elastic-resume on
                    the survivors (the port's `runtime.elastic` picks the
                    new mesh; one card still shards nothing, so the port
                    plans such a resize and runs none).

The *decision threshold* is not a magic constant: the ESF fabric model
quantifies what a degraded link does to a step (`estimate_step_impact`), and
eviction is chosen only when the modeled loss from running degraded exceeds
the modeled cost of a restart — the paper's simulate-to-decide loop applied
to the trainer itself.  The fabric is the simulated TPU pod of
`core.fabric_model`; its schedule is resolved on ``device`` (the card
unless the caller asks for the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.fabric_model import predict_collective


@dataclass
class StragglerDetector:
    alpha: float = 0.1
    k_sigma: float = 3.0
    patience: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    strikes: dict = field(default_factory=dict)

    def observe(self, worker: int, step_time_s: float) -> str:
        """Returns: ok | suspect | straggler."""
        if self.n < 3:  # bootstrap
            self.n += 1
            self.mean = (self.mean * (self.n - 1) + step_time_s) / self.n
            return "ok"
        import math

        sigma = math.sqrt(max(self.var, 1e-12))
        outlier = step_time_s > self.mean + self.k_sigma * sigma \
            and step_time_s > 1.05 * self.mean
        if not outlier:
            # robust EWMA: only non-outliers update the baseline, otherwise a
            # sustained straggler poisons its own detection threshold
            d = step_time_s - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
            self.strikes[worker] = 0
            return "ok"
        self.strikes[worker] = self.strikes.get(worker, 0) + 1
        return ("straggler" if self.strikes[worker] >= self.patience
                else "suspect")


def estimate_step_impact(fabric, graph, *, grad_bytes_per_chip: int,
                         slow_factor: float, compute_s: float,
                         device="cuda", simulate_fn=None) -> dict:
    """Model a degraded chip's effect on step time via the fabric engine:
    the ring all-reduce stalls at the slow link, so the collective stretches
    by ~slow_factor while compute is unaffected on other chips."""
    base = predict_collective(fabric, graph, "all_reduce", "x",
                              grad_bytes_per_chip, device, simulate_fn)
    degraded_s = base.seconds * slow_factor
    return {
        "healthy_step_s": compute_s + base.seconds,
        "degraded_step_s": compute_s + degraded_s,
        "slowdown": (compute_s + degraded_s) / (compute_s + base.seconds),
    }


def mitigation_decision(slowdown: float, restart_cost_steps: float,
                        remaining_steps: int) -> str:
    """Evict when cumulative degraded time exceeds the restart cost."""
    excess = (slowdown - 1.0) * remaining_steps
    if slowdown < 1.02:
        return "ignore"
    if excess < restart_cost_steps:
        return "rebalance"
    return "checkpoint_evict"
