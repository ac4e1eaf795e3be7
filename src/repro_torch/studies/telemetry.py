"""Telemetry layer: metric reductions over a stochastic-BER sweep, with the
observer and conservation gates, on the port.

The counterpart of ``benchmarks/bench_telemetry.py``, row for row: the
telemetry pass — latency attribution, per-channel counters, windowed
series, quantile-sketch fold — over the members of a three-BER sweep of the
link-reliability bus (flit quantization, sampled replay bytes, retraining
markers).  The sweep is one `engine.simulate_stacked` call; the reference's
``jax.vmap`` of each reduction is a loop over `engine.member`s.  On the card
every retraining replay (`engine.replay_round`) is one launch of the fused
serve round.

Acceptance gates (AssertionErrors):

  * conservation — attribution components sum exactly to
    ``complete − issue`` on every request at every BER;
  * ordering — sketch p50 <= p99 <= p99.9, channel utilization in [0, 1];
  * retraining — the retraining stall grows with BER;
  * blame — `channel_blame` conserves on the heaviest member;
  * pure observer — re-simulating after the telemetry and trace pass is
    bit-identical;
  * trace — the heaviest member's Chrome trace
    (`trace_export.schedule_trace`) passes `validate_trace`.
"""

from __future__ import annotations

import torch

from ..core import telemetry as tm
from ..core import topology as T
from ..core import trace_export as tx
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import (SimOptions, member, round_bound, simulate_stacked,
                           stack_members, to_host)
from ..core.link_layer import FlitConfig
from ..core.verify import verify_built
from .common import Row, StudyLog, Timer
from .link_reliability import _pad

BUS_BW = 128_000
BERS = (1e-5, 1e-4, 3e-4)
REPS = 3


def _bus_wl(ber: float, n: int, device="cuda", log=None):
    log = log or StudyLog()
    with log.phase("lower"):
        cfg = FlitConfig("flit256", ber=ber, reliability="stochastic",
                         rel_seed=7, retrain_threshold=2,
                         retrain_ps=1_000_000)
        topo = T.with_flit(T.single_bus(n_mems=4, bw_MBps=BUS_BW), cfg)
        spec = RequesterSpec(node=0, n_requests=n, targets=[2, 3, 4, 5],
                             read_ratio=0.5, issue_interval_ps=300,
                             payload_bytes=944, seed=3)
        graph = topo.build()
        wl = build_workload(graph, [spec], warmup_frac=0.0, device=device)
    with log.phase("verify"):
        verify_built(wl, graph).raise_if_failed()
    return wl


def metric_pass(hops, channels, sched, issue_ps, n_bins: int = 32):
    """The reference's ``metric_sweep`` for one member: (attribution,
    channel counters, windowed series, latency quantiles)."""
    att = tm.attribute_latency(hops, channels, sched, issue_ps)
    chans = tm.channel_telemetry(hops, channels, sched)
    series = tm.windowed_series(hops, channels, sched, issue_ps,
                                n_bins=n_bins)
    sk = tm.sketch_update(tm.sketch_new(issue_ps.device), att.total_ps)
    return att, chans, series, tm.sketch_quantiles(sk)


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    log = log or StudyLog()
    rows: list[Row] = []
    n = 150 if quick else 600
    m = len(BERS)

    wls = [_bus_wl(b, n, device=device, log=log) for b in BERS]
    with log.phase("lower"):
        h_max = max(w.hops.channel.shape[1] for w in wls)
        stacked = stack_members([_pad(w.hops, h_max) for w in wls])
        ch, issue = wls[0].channels, wls[0].issue_ps
        chs = stack_members([ch] * m)
        issues = torch.stack([issue] * m)
    # the reference resolves the round bound host-side from the stacked
    # tables and passes it to every vmapped member
    opts = SimOptions(max_rounds=round_bound(stacked))

    def schedule_sweep(hops, channels, issue_ps):
        return simulate_stacked(hops, channels, issue_ps, opts)

    sched = log.simulate("ber_sweep", schedule_sweep, stacked, chs, issues,
                         stacked=True)
    with Timer() as t:
        for _ in range(REPS):
            schedule_sweep(stacked, chs, issues)
        log.sync()
    t_sched = t.us / REPS
    assert all(sched.converged), "BER sweep failed to converge"

    members = [(member(stacked, i), member(sched, i)) for i in range(m)]

    def metric_sweep():
        return [metric_pass(h, ch, s, issue) for h, s in members]

    metric_sweep()
    with Timer() as t:
        for _ in range(REPS):
            out = metric_sweep()
        log.sync()
    t_metrics = t.us / REPS
    att = [o[0] for o in out]
    chans = [o[1] for o in out]

    # gates -----------------------------------------------------------------
    resid = max(int(tm.conservation_residual(a).abs().max()) for a in att)
    assert resid == 0, f"conservation violated by {resid} ps"
    util = torch.stack([c.utilization for c in chans])
    assert bool((util >= 0).all()) and bool((util <= 1).all()), \
        "utilization out of [0,1]"
    q = to_host(torch.stack([o[3] for o in out]))
    assert ((q[:, 0] <= q[:, 1]) & (q[:, 1] <= q[:, 2])).all(), \
        "quantiles out of order"

    # pure observer: the telemetry + trace pass cannot perturb a schedule
    before = sched.complete.clone()
    last_hops, last_sched = members[-1]
    trace = tx.schedule_trace(last_hops, ch, last_sched)
    errs = tx.validate_trace(trace)
    assert errs == [], f"trace schema violations: {errs[:3]}"
    again = schedule_sweep(stacked, chs, issues)
    assert torch.equal(before, again.complete), \
        "telemetry perturbed the schedule"

    n_hops = int(stacked.valid.sum())
    rows.append(Row(
        "telemetry/schedule_sweep", t_sched,
        f"bers={m};rows={n};hops={n_hops}",
        meta={"engine_rounds": [int(r) for r in sched.rounds],
              "engine_converged": True},
    ))
    stalls = [int(a.retrain_stall_ps.sum()) for a in att]
    for i, b in enumerate(BERS):
        stall_ns = stalls[i] / 1e3
        rows.append(Row(
            f"telemetry/attribution_ber{b:g}", t_metrics,
            f"p50={q[i, 0] / 1e3:.0f}ns;p99={q[i, 1] / 1e3:.0f}ns;"
            f"p999={q[i, 2] / 1e3:.0f}ns;retrain_stall={stall_ns:.0f}ns",
            meta={"quantiles_ps": [int(x) for x in q[i]],
                  "retrain_stall_ps": stalls[i],
                  "queue_wait_ps": int(att[i].queue_wait_ps.sum()),
                  "peak_backlog": [int(x) for x in
                                   to_host(chans[i].peak_backlog)]},
        ))
    # retraining stall must ramp with BER (the attribution separates it
    # from FCFS queueing; identical workload otherwise)
    assert stalls[0] < stalls[-1], "retrain stall did not grow with BER"
    # per-channel blame conserves end to end on the heaviest table
    bl = tm.channel_blame(last_hops, ch, last_sched, issue)
    assert int(tm.blame_conservation_residual(bl)) == 0, \
        "channel_blame does not conserve complete - issue"
    n_events = sum(1 for e in trace["traceEvents"] if e["ph"] != "M")
    max_util = float(util.max())
    rows.append(Row(
        "telemetry/metrics_per_sweep", t_metrics,
        f"conservation=0ps;max_util={max_util:.3f};"
        f"trace_events={n_events};trace_valid=True;blame_residual=0ps",
        meta={"max_utilization": max_util,
              "blame": {"queue_ps": int(bl.queue_ps.sum()),
                        "retrain_ps": int(bl.retrain_ps.sum()),
                        "wire_ps": int(bl.wire_ps.sum()),
                        "row_extra_ps": int(bl.row_extra_ps.sum()),
                        "join_ps": int(bl.join_ps),
                        "fixed_ps": int(bl.fixed_ps)}},
    ))
    return rows
