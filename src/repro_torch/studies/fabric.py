"""Framework study: the ESF fabric model against analytic collective costs,
on the port.

The counterpart of ``benchmarks/bench_fabric.py``, row for row: the engine
predicts collective times on the simulated TPU v5e torus
(`core.fabric_model`).  The simulated ring collectives must agree with the
closed-form alpha-beta model (there is no contention), and the all-to-all
(MoE dispatch) shows the contention penalty the analytic model misses;
at full size a 2-pod DCN all-reduce is added.  Every collective is one
schedule, resolved on ``device`` and recorded in the `StudyLog`.
"""

from __future__ import annotations

from ..core.engine import simulate
from ..core.fabric_model import (TPUFabric, analytic_ring_seconds,
                                 predict_collective)
from .common import Row, StudyLog, Timer

MB = 1 << 20


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    log = log or StudyLog()

    def predict(label, fab, graph, kind, nbytes):
        def recorded(hops, channels, issue_ps):
            return log.simulate(label, simulate, hops, channels, issue_ps)

        return predict_collective(fab, graph, kind, "x", nbytes, device,
                                  recorded)

    rows: list[Row] = []
    with log.phase("lower"):
        fab = TPUFabric(nx=8 if quick else 16, ny=8 if quick else 16)
        graph = fab.build()
    sizes = (16 * MB, 128 * MB) if quick else (16 * MB, 64 * MB, 256 * MB)
    for nbytes in sizes:
        name = f"all_reduce/{nbytes // MB}MB"
        with Timer() as t:
            ar = predict(name, fab, graph, "all_reduce", nbytes)
        ana = analytic_ring_seconds(nbytes, fab.nx)
        rows.append(Row(
            f"fabric/{name}", t.us,
            f"sim_ms={ar.seconds * 1e3:.3f};alpha_beta_ms={ana * 1e3:.3f};"
            f"ratio={ar.seconds / ana:.3f}",
        ))
    with Timer() as t:
        a2a = predict("all_to_all/64MB", fab, graph, "all_to_all", 64 * MB)
    naive = 64 * MB / fab.nx * (fab.nx - 1) / (50_000 * 1e6 * 2)
    rows.append(Row(
        "fabric/all_to_all/64MB", t.us,
        f"sim_ms={a2a.seconds * 1e3:.3f};contention_free_ms={naive * 1e3:.3f};"
        f"contention_factor={a2a.seconds / naive:.2f}",
    ))
    if not quick:
        with log.phase("lower"):
            fab2 = TPUFabric(nx=16, ny=16, pods=2)
            graph2 = fab2.build()
        with Timer() as t:
            pr = predict("pod_all_reduce/64MB", fab2, graph2,
                         "pod_all_reduce", 64 * MB)
        rows.append(Row(
            "fabric/pod_all_reduce/64MB", t.us,
            f"sim_ms={pr.seconds * 1e3:.3f};detail={pr.detail}",
        ))
    return rows
