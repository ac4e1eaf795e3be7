"""What the studies share: the result row, a timer, and a run log.

A study's ``run(quick, device, log)`` returns `Row`s named and formatted as
the reference's ``benchmarks/bench_*.py`` rows (``name``, host µs of the
step, the ``derived`` payload with its pass flags).  A `StudyLog`, when the
caller passes one, keeps what the study did on the way: host seconds per
phase (``lower`` — `build_workload` and the reliability sampling and
marker insertion; ``verify``; ``simulate``) and every schedule it resolved,
with the tables it came from and the serve-scan launches it took, so a
caller can time the phases apart and hold each schedule against the oracle.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Row:
    name: str
    us_per_call: float
    derived: str

    def csv(self) -> str:
        return f"{self.name},{self.us_per_call:.3f},{self.derived}"


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.us = (time.perf_counter() - self.t0) * 1e6


@dataclass
class Run:
    """One resolved schedule: ``stacked`` runs carry a leading member axis
    on every table (`engine.simulate_stacked`)."""

    label: str
    hops: object
    channels: object
    issue_ps: object
    schedule: object
    stacked: bool
    launches: int


@dataclass
class StudyLog:
    """Host seconds per phase and every schedule a study resolved.

    ``sync`` is called at the edges of every phase (pass
    ``torch.cuda.synchronize`` on the card, so a phase's host time covers
    its device work); ``launches`` returns the serve-scan launch count, read
    around every simulation."""

    sync: Callable[[], None] = lambda: None
    launches: Callable[[], int] = lambda: 0
    seconds: dict = field(default_factory=dict)
    runs: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)

    def simulate(self, label, fn, hops, channels, issue_ps, *,
                 stacked=False):
        """``fn(hops, channels, issue_ps)`` timed as ``simulate`` and
        recorded; returns what ``fn`` returns."""
        with self.phase("simulate"):
            before = self.launches()
            out = fn(hops, channels, issue_ps)
            n = self.launches() - before
        # simulate_auto returns (schedule, used_oracle); a Schedule is a
        # NamedTuple itself
        sched = out[0] if type(out) is tuple else out
        self.runs.append(Run(label, hops, channels, issue_ps, sched,
                             stacked, n))
        return out
