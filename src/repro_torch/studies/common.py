"""What the studies share: the result row, a timer, and a run log.

A study's ``run(quick, device, log)`` returns `Row`s named and formatted as
the reference's ``benchmarks/bench_*.py`` rows (``name``, host µs of the
step, the ``derived`` payload with its pass flags).  A `StudyLog`, when the
caller passes one, keeps what the study did on the way: host seconds per
phase (``lower`` — `build_workload` and the reliability sampling and
marker insertion, or a coherence study's stream and event lowering;
``route`` — the routing study's lowering and route choice; ``verify``;
``sf_scan`` — the coherence studies' snoop-filter scans; ``simulate``) and
every schedule it resolved, with the tables it came from and the
serve-scan launches it took, so a caller can time the phases apart and
hold each schedule against the oracle.  The coherence studies also keep
their `SFResult`s (``scans``), and Fig. 14 its `SFEvents` logs
(``events``).
"""

from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass, field
from typing import Callable

from ..core.engine import SimOptions, simulate_auto

# Where the reference's benches call ``simulate_auto``, the port's studies
# run the fixpoint on past its round bound on the tables' device before the
# host oracle would answer (``check="extend"``): a converged fixpoint is the
# oracle's exact schedule, so the rows are the reference's, computed on the
# card.
simulate_exact = functools.partial(simulate_auto,
                                   options=SimOptions(check="extend"))


@dataclass
class Row:
    name: str
    us_per_call: float
    derived: str
    # structured values riding along (convergence counters, quantiles), as
    # the reference's rows carry them; never printed in the CSV line
    meta: dict | None = None

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
    on every table (`engine.simulate_stacked`); ``used_oracle`` says that
    `engine.simulate_auto` answered with the oracle's schedule."""

    label: str
    hops: object
    channels: object
    issue_ps: object
    schedule: object
    stacked: bool
    launches: int
    used_oracle: bool = False


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
    scans: list = field(default_factory=list)  # (label, SFResult)
    events: dict = field(default_factory=dict)  # label -> SFEvents
    _inner: list = field(default_factory=list, repr=False)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a phase; a phase opened inside another counts for itself
        only, and the outer one keeps the rest."""
        self.sync()
        t0 = time.perf_counter()
        self._inner.append(0.0)
        try:
            yield
        finally:
            self.sync()
            took = time.perf_counter() - t0
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + took - self._inner.pop())
            if self._inner:
                self._inner[-1] += took

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
        sched, used_oracle = out if type(out) is tuple else (out, False)
        self.runs.append(Run(label, hops, channels, issue_ps, sched,
                             stacked, n, used_oracle))
        return out
