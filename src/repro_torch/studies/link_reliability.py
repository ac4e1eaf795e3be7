"""Tail latency under stochastic link reliability, on the port.

The counterpart of ``benchmarks/bench_link_reliability.py``, row for row,
on the §IV validation bus in ``reliability="stochastic"`` mode (seeded
per-flit Go-Back-N replay counts plus retraining stalls sampled at build
time):

  * **zero-BER equivalence** — at BER 0 the sampled tables are all zero, so
    the stochastic schedule must equal the deterministic one exactly
    (acceptance gate);
  * **tail sweep** — p50/p99 request latency vs BER for both reliability
    modes, each mode one `simulate_stacked` call (the expected mode stacks
    the per-BER ``replay_ppm`` channel tables; the stochastic mode stacks
    the per-BER sampled hop tables, padded to one width).  The stochastic
    p99-p50 spread must grow with BER and overtake the expected-value
    spread (acceptance gate);
  * **retraining stalls** — enabling retraining on one seeded fault history
    must strictly delay the makespan (acceptance gate).

Percentiles are linear interpolation in float64, computed as the
reference's ``jnp.percentile`` computes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import topology as T
from ..core.calibration import PCIE6_X16_RAW_MBPS
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import (member, simulate, simulate_stacked, stack_members,
                           to_device, to_host)
from ..core.link_layer import (FlitConfig, apply_retrain_markers,
                               broadcast_reliability_tables,
                               replay_overhead_ppm, sample_hop_tables,
                               strip_retrain_markers)
from ..core.verify import verify_built
from .common import Row, StudyLog, Timer

BERS = (0.0, 1e-6, 1e-5, 3e-5, 1e-4)
RETRAIN_THRESHOLD = 2
RETRAIN_PS = 1_000_000  # 1 us link-down per retraining event


def percentile(x: torch.Tensor, p: float) -> float:
    """``jnp.percentile(x, p)`` (linear method) of a 1-D float64 tensor:
    the same index arithmetic and the same ``low*(1-w) + high*w`` in
    float64."""
    v = torch.sort(x).values
    n = v.shape[0]
    q = (p / 100.0) * (n - 1)
    lo, hi = math.floor(q), math.ceil(q)
    hw = q - lo
    return float(v[lo]) * (1.0 - hw) + float(v[hi]) * hw


def _bus_workload(flit, n: int, payload: int = 944, seed: int = 11,
                  with_graph: bool = False, device="cuda", log=None):
    """§IV validation system, saturated open loop (944 B = 4 full flits)."""
    log = log or StudyLog()
    with log.phase("lower"):
        topo = T.with_flit(T.single_bus(n_mems=4,
                                        bw_MBps=PCIE6_X16_RAW_MBPS), flit)
        graph = topo.build()
        spec = RequesterSpec(node=0, n_requests=n, targets=[2, 3, 4, 5],
                             pattern="uniform", read_ratio=0.5,
                             issue_interval_ps=100, payload_bytes=payload,
                             seed=seed)
        wl = build_workload(graph, [spec], header_bytes=64, warmup_frac=0.0,
                            device=device)
    with log.phase("verify"):
        verify_built(wl, graph).raise_if_failed()
    return (wl, graph) if with_graph else wl


def _stochastic_cfg(ber: float, rel_seed: int = 0,
                    retrain_threshold: int = RETRAIN_THRESHOLD) -> FlitConfig:
    return FlitConfig("flit256", ber=ber, reliability="stochastic",
                      rel_seed=rel_seed, retrain_threshold=retrain_threshold,
                      retrain_ps=RETRAIN_PS)


_FILLS = dict(channel=-1, nbytes=0, direction=0, row=-1, fixed_after_ps=0,
              is_payload=False, valid=False, extra_wire_bytes=0,
              retrain_after_ps=0)


def _pad(h, width: int):
    """Hops widened to ``width`` columns with the padding fills."""
    def pad(x, v):
        fill = torch.full((x.shape[0], width - x.shape[1]), v,
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, fill], dim=1)

    return h._replace(**{f: pad(getattr(h, f), v) for f, v in _FILLS.items()})


def run_tail_sweep(bers=BERS, n: int = 1500, rel_seed: int = 0,
                   device="cuda", log=None) -> list[dict]:
    """Per BER: p50/p99 latency (ns) of the expected and stochastic modes,
    each mode one stacked fixpoint over an identical hop layout."""
    log = log or StudyLog()
    wl, graph = _bus_workload(FlitConfig("flit256"), n, with_graph=True,
                              device=device, log=log)
    m = len(bers)
    issue = torch.stack([wl.issue_ps] * m)
    with log.phase("lower"):
        link = wl.channels.flit_size > 0
        ch_e = stack_members([wl.channels._replace(replay_ppm=torch.where(
            link, torch.full_like(wl.channels.replay_ppm,
                                  replay_overhead_ppm(b, "flit256")), 0))
            for b in bers])
        hops_e = stack_members([wl.hops] * m)
    s_e = log.simulate("tail/expected", simulate_stacked, hops_e, ch_e,
                       issue, stacked=True)
    assert all(s_e.converged), "expected-mode sweep failed to converge"

    # stochastic: sample each BER's tables off the shared workload's arrays
    # (the streams a per-BER build would draw: same channel ids, seeds and
    # parameters) and mirror the full-duplex retraining stalls as the build
    # path does; marker insertion widens rows per BER, so the tables are
    # padded to one width and stacked
    with log.phase("lower"):
        c = int(wl.channels.bw_MBps.shape[0])
        chan_np = to_host(wl.hops.channel)
        nbytes_np = to_host(wl.hops.nbytes)
        valid_np = to_host(wl.hops.valid)
        link_np = to_host(wl.channels.flit_size) > 0
        hops_by_ber = []
        for b in bers:
            extra, retrain = sample_hop_tables(
                chan_np, nbytes_np, valid_np,
                **broadcast_reliability_tables(_stochastic_cfg(b, rel_seed),
                                               c, link_np))
            hops_by_ber.append(apply_retrain_markers(
                wl.hops._replace(
                    extra_wire_bytes=to_device(extra, wl.hops.channel.device),
                    retrain_after_ps=to_device(retrain,
                                               wl.hops.channel.device)),
                graph.chan_pair))
        ch_s = wl.channels._replace(
            replay_ppm=torch.zeros_like(wl.channels.replay_ppm))
        h_max = max(h.channel.shape[1] for h in hops_by_ber)
        hops_s = stack_members([_pad(h, h_max) for h in hops_by_ber])
        chs_s = stack_members([ch_s] * m)
    s_s = log.simulate("tail/stochastic", simulate_stacked, hops_s, chs_s,
                       issue, stacked=True)
    assert all(s_s.converged), "stochastic sweep failed to converge"

    out = []
    for i, b in enumerate(bers):
        lat_e = (member(s_e, i).complete - wl.issue_ps).double() / 1000
        lat_s = (member(s_s, i).complete - wl.issue_ps).double() / 1000
        out.append({
            "ber": b,
            "expected_p50_ns": percentile(lat_e, 50),
            "expected_p99_ns": percentile(lat_e, 99),
            "stochastic_p50_ns": percentile(lat_s, 50),
            "stochastic_p99_ns": percentile(lat_s, 99),
        })
    return out


def run_zero_ber_equivalence(n: int = 800, device="cuda", log=None) -> bool:
    """BER-0 stochastic schedule == deterministic schedule, bit for bit."""
    log = log or StudyLog()
    wl_e = _bus_workload(FlitConfig("flit256"), n, device=device, log=log)
    wl_s = _bus_workload(_stochastic_cfg(0.0), n, device=device, log=log)
    s_e = log.simulate("zero_ber/expected", simulate, wl_e.hops,
                       wl_e.channels, wl_e.issue_ps)
    s_s = log.simulate("zero_ber/stochastic", simulate, wl_s.hops,
                       wl_s.channels, wl_s.issue_ps)
    return (torch.equal(s_e.complete, s_s.complete)
            and torch.equal(s_e.start, s_s.start))


def run_retrain_stall(ber: float = 1e-4, n: int = 800, rel_seed: int = 0,
                      device="cuda", log=None) -> dict:
    """Makespan with vs without retraining on one seeded fault history.

    Threshold 0 disables retraining but draws the replay totals from the
    same stream, so the two runs share every sampled replay burst and
    differ only by the link-down intervals.
    """
    log = log or StudyLog()
    wl_off = _bus_workload(_stochastic_cfg(ber, rel_seed,
                                           retrain_threshold=0), n,
                           device=device, log=log)
    wl_on = _bus_workload(_stochastic_cfg(ber, rel_seed), n, device=device,
                          log=log)
    assert torch.equal(
        wl_off.hops.extra_wire_bytes,
        strip_retrain_markers(wl_on.hops).extra_wire_bytes)
    s_off = log.simulate("retrain/off", simulate, wl_off.hops,
                         wl_off.channels, wl_off.issue_ps)
    s_on = log.simulate("retrain/on", simulate, wl_on.hops, wl_on.channels,
                        wl_on.issue_ps)
    retrain = to_host(wl_on.hops.retrain_after_ps)
    return {
        "events": int((retrain > 0).sum()),
        "down_ns_total": int(np.sum(retrain)) / 1000,
        "makespan_off_ns": int(s_off.complete.max()) / 1000,
        "makespan_on_ns": int(s_on.complete.max()) / 1000,
    }


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    log = log or StudyLog()
    rows: list[Row] = []
    n = 500 if quick else 1500

    with Timer() as t:
        ok = run_zero_ber_equivalence(min(n, 800), device=device, log=log)
    rows.append(Row("link_reliability/zero_ber_equivalence", t.us,
                    f"stochastic_matches_deterministic={ok}"))
    assert ok, "zero-BER stochastic != deterministic (acceptance gate)"

    with Timer() as t:
        # quick mode keeps the endpoints: the divergence is decisive at the
        # top BER, not in the middle of the range
        sweep = run_tail_sweep((0.0, 1e-5, 1e-4) if quick else BERS, n=n,
                               device=device, log=log)
    for r in sweep:
        rows.append(Row(f"link_reliability/tail/ber{r['ber']:g}", t.us,
                        f"exp_p50={r['expected_p50_ns']:.0f};"
                        f"exp_p99={r['expected_p99_ns']:.0f};"
                        f"sto_p50={r['stochastic_p50_ns']:.0f};"
                        f"sto_p99={r['stochastic_p99_ns']:.0f}"))
    spread0 = sweep[0]["stochastic_p99_ns"] - sweep[0]["stochastic_p50_ns"]
    spread1 = sweep[-1]["stochastic_p99_ns"] - sweep[-1]["stochastic_p50_ns"]
    spread_e = sweep[-1]["expected_p99_ns"] - sweep[-1]["expected_p50_ns"]
    diverges = spread1 > spread0 and spread1 > spread_e
    rows.append(Row("link_reliability/tail_divergence", t.us,
                    f"p99_minus_p50_ber0={spread0:.0f};"
                    f"p99_minus_p50_top={spread1:.0f};"
                    f"expected_top={spread_e:.0f};"
                    f"diverges={diverges}"))
    assert diverges, "stochastic tail fails to diverge (acceptance gate)"

    with Timer() as t:
        st = run_retrain_stall(n=min(n, 800), device=device, log=log)
    rows.append(Row("link_reliability/retrain_stall", t.us,
                    f"events={st['events']};down_ns={st['down_ns_total']:.0f};"
                    f"makespan_off={st['makespan_off_ns']:.0f};"
                    f"makespan_on={st['makespan_on_ns']:.0f};"
                    f"stalls={st['makespan_on_ns'] > st['makespan_off_ns']}"))
    assert st["makespan_on_ns"] > st["makespan_off_ns"], \
        "retraining fails to stall the schedule (acceptance gate)"
    return rows
