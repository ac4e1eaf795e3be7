"""Critical-path extraction and bottleneck blame: acceptance gates and
artifact, on the port.

The counterpart of ``benchmarks/bench_critical_path.py``: `core.
critical_path` over two representative fabrics, gating the invariants the
observability layer promises (AssertionErrors):

  * **conservation**: every request's critical-path edge contributions
    sum exactly to ``complete − issue`` (`blame` raises otherwise), and
    the aggregated table equals the summed path totals;
  * **pure observer**: extraction replays the scan on host copies; the
    schedule re-simulates bit for bit afterwards, and
    `extract_backpointers(check=True)` asserts its replayed grant times
    equal the engine's (on the card: the fused serve-round kernel's);
  * **flow trace**: the Perfetto export with gating-edge flows and the
    blame counter track passes `validate_trace` with zero violations;
  * **what-ifs**: `speedup_if` is exact at ``factor == 1`` (zero saved
    ps) and monotone in the factor on the busiest channel;
  * **streamed blame**: the windowed `StreamTelemetry` blame fold equals
    monolithic `channel_blame` bit for bit on the streaming study's config;
  * **protocol legs**: `coherence_traffic.leg_blame` buckets the
    coherence config's paths into BISnp/BIRsp/writeback/demand legs and
    conserves the summed path totals.

Rows: ``critical_path/coherence_fabric`` (snooped misses on the star
coherence fabric, the scan through `kernels.sf_scan`),
``critical_path/reliability_bus`` (the §IV bus under a stochastic flit
link, where RETRAIN edges bind) and ``critical_path/streaming_blame_gate``
(the blame folded window by window through `core.streaming`, 512-row
windows of the streaming study's trace).

Writes the aggregated blame tables, top-k bottlenecks, per-switch rollup
and what-if results to ``blame-critical-path.json`` in the working
directory, as the reference does.
"""

from __future__ import annotations

import json

import torch

from ..core import topology as T
from ..core.calibration import PCIE6_X16_RAW_MBPS
from ..core.coherence_traffic import (coherence_issue, leg_blame,
                                      lower_coherence)
from ..core.critical_path import (KIND_NAMES, blame, critical_paths,
                                  extract_backpointers, path_total,
                                  speedup_if)
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import make_channels, simulate
from ..core.link_layer import FlitConfig
from ..core.snoop_filter import (CacheConfig, SFConfig,
                                 make_sequential_stream, simulate_sf)
from ..core.streaming import simulate_stream, stream_windows
from ..core.telemetry import channel_blame
from ..core.trace_export import (channel_names, schedule_trace,
                                 validate_trace)
from ..core.verify import verify_built
from .coherence_fabric import build_coherence_fabric
from .common import Row, StudyLog, Timer
from .streaming import _blame_equal, _blame_json
from .streaming import _channels as _stream_channels
from .streaming import _chunk as _stream_chunk

ARTIFACT = "blame-critical-path.json"


def _coherence_config(quick: bool, device="cuda", log=None):
    """Snooped misses on the star coherence fabric (concurrent fan-out)."""
    log = log or StudyLog()
    graph, spec, _ = build_coherence_fabric(2)
    ep = graph.topo.endpoint
    channels = make_channels(graph, ep.row_hit_extra_ps, ep.row_miss_extra_ps,
                             device=device)
    n = 200 if quick else 600
    addr, wr, rid = make_sequential_stream(n, 128, n_requesters=2,
                                           device=device)
    cfg = SFConfig(capacity=16, policy="fifo", footprint_lines=128)
    with log.phase("sf_scan"):
        _, ev = simulate_sf(addr, wr, rid, cfg, CacheConfig(capacity=16),
                            n_requesters=2, return_events=True)
    low = lower_coherence(graph, spec, cfg, addr, wr, rid, ev,
                          fanout="concurrent", device=device)
    return graph, channels, low, coherence_issue(low, ev.fab_issue_ps)


def _reliability_config(quick: bool, device="cuda", log=None):
    """§IV bus under a stochastic flit link with retraining stalls: the
    layout family where RETRAIN edges actually bind."""
    log = log or StudyLog()
    flit = FlitConfig("flit256", ber=1e-4, reliability="stochastic",
                      rel_seed=3, retrain_threshold=2, retrain_ps=1_000_000)
    topo = T.with_flit(T.single_bus(n_mems=4, bw_MBps=PCIE6_X16_RAW_MBPS),
                       flit)
    graph = topo.build()
    spec = RequesterSpec(node=0, n_requests=150 if quick else 500,
                         targets=[2, 3, 4, 5], pattern="uniform",
                         read_ratio=0.5, issue_interval_ps=100,
                         payload_bytes=944, seed=11)
    wl = build_workload(graph, [spec], header_bytes=64, warmup_frac=0.0,
                        device=device)
    with log.phase("verify"):
        verify_built(wl, graph).raise_if_failed()
    return graph, wl.channels, wl.hops, wl.issue_ps


def _gate_config(name, hops, channels, issue, graph=None, log=None):
    """Run every per-config gate; returns (backpointers, paths, blame,
    artifact entry)."""
    log = log or StudyLog()
    sched = log.simulate(name, simulate, hops, channels, issue)
    assert sched.converged, f"{name}: schedule did not converge"
    # extraction asserts replayed grants == engine grants (check=True)
    bp = extract_backpointers(hops, channels, sched, issue)
    paths = critical_paths(bp)
    bl = blame(bp, paths=paths)  # raises on any conservation violation
    assert bl.total_ps == sum(path_total(p) for p in paths)
    assert bl.total_ps == int((bp.complete - bp.issue).sum())

    # pure observer: the schedule re-simulates bit for bit after extraction
    sched2 = simulate(hops, channels, issue)
    for field in ("start", "depart", "arrive", "complete"):
        assert torch.equal(getattr(sched, field), getattr(sched2, field)), \
            f"{name}: extraction perturbed the schedule ({field})"

    # flow-event trace passes the schema gate
    names = channel_names(graph) if graph is not None else None
    trace = schedule_trace(hops, channels, sched, names=names,
                           flows=bp, blame=bl)
    errs = validate_trace(trace)
    assert not errs, f"{name}: trace schema violations: {errs[:3]}"

    # what-ifs on the busiest channel: identity at 1x, monotone beyond
    busiest = int(bl.by_channel()[:-1].argmax())
    what_ifs = {}
    saved_prev = -1
    for factor in (1.0, 2.0, 4.0):
        w = speedup_if(bp, busiest, factor)
        saved = int(w["saved_ps"])
        if factor == 1.0:
            assert saved == 0, f"{name}: speedup_if(1.0) saved {saved} ps"
        assert saved >= saved_prev, \
            f"{name}: speedup_if not monotone at {factor}x"
        saved_prev = saved
        what_ifs[f"{factor:g}x"] = {
            "saved_ps": saved,
            "mean_latency_ps": int(w["mean_latency_ps"]),
            "baseline_mean_latency_ps": int(w["baseline_mean_latency_ps"]),
        }

    entry = {
        "n_requests": bl.n_requests,
        "total_ps": bl.total_ps,
        "by_kind": bl.by_kind(),
        "by_channel": [int(v) for v in bl.by_channel()],
        "top": [{"channel": t["channel"], "kind": t["kind"],
                 "ps": t["ps"], "share": round(t["share"], 4)}
                for t in bl.top(5)],
        "flow_events": sum(1 for e in trace["traceEvents"]
                           if e.get("ph") == "s"),
        "busiest_channel": busiest,
        "speedup_if": what_ifs,
    }
    if graph is not None:
        entry["by_switch"] = {str(k): v
                              for k, v in bl.by_switch(graph).items()}
    return bp, paths, bl, entry


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    log = log or StudyLog()
    rows: list[Row] = []
    artifact: dict = {}

    # ---- coherence fabric: blame + protocol-leg mapping ------------------
    with log.phase("lower"):
        graph, channels, low, issue = _coherence_config(quick, device, log)
    with Timer() as t, log.phase("execute"):
        bp, paths, bl, entry = _gate_config(
            "coherence", low.hops, channels, issue, graph=graph, log=log)
    legs = leg_blame(low, paths)
    assert sum(legs.values()) == bl.total_ps, \
        "leg blame does not conserve the summed path totals"
    assert legs["bisnp"] > 0 and legs["service"] > 0, \
        f"coherence paths never crossed snoop/service legs: {legs}"
    entry["leg_blame"] = legs
    artifact["coherence_fabric"] = entry
    top = bl.top(1)[0]
    rows.append(Row(
        "critical_path/coherence_fabric", t.us,
        f"rows={bp.n};total_ms={bl.total_ps / 1e9:.2f};"
        f"top={top['kind']}@ch{top['channel']}:{top['share']:.0%};"
        f"conservation=exact",
        meta=entry))

    # ---- reliability bus: retrain edges on the critical path -------------
    with log.phase("build"):
        rgraph, rch, rhops, rissue = _reliability_config(quick, device, log)
    with Timer() as t, log.phase("execute"):
        _, _, rbl, rentry = _gate_config(
            "reliability", rhops, rch, rissue, graph=rgraph, log=log)
    assert rbl.by_kind()["retrain"] > 0, \
        "stochastic retraining config produced no RETRAIN blame"
    artifact["reliability_bus"] = rentry
    rows.append(Row(
        "critical_path/reliability_bus", t.us,
        f"rows={rentry['n_requests']};"
        f"retrain_us={rbl.by_kind()['retrain'] / 1e6:.1f};"
        f"queue_us={rbl.by_kind()['queue'] / 1e6:.1f};conservation=exact",
        meta=rentry))

    # ---- streaming smoke: windowed blame fold == monolithic --------------
    with log.phase("build"):
        sch = _stream_channels(device)
        shops, sissue = _stream_chunk(0, 2000 if quick else 8000, 0, seed=0,
                                      device=device)
    with Timer() as t, log.phase("execute"):
        mono = log.simulate("streaming_smoke/monolithic", simulate, shops,
                            sch, sissue)
        assert mono.converged
        mb = channel_blame(shops, sch, mono, sissue)
        out = simulate_stream(stream_windows(shops, sissue, 512), sch)
        sb = out.summary()["blame"]
    _blame_equal(sb, mb, "!= monolithic channel_blame")
    artifact["streaming_smoke"] = {"windows": out.windows,
                                   "blame": _blame_json(sb)}
    rows.append(Row(
        "critical_path/streaming_blame_gate", t.us,
        f"windows={out.windows};blame=bitexact",
        meta=artifact["streaming_smoke"]))

    host_phases = {k: round(v, 6) for k, v in sorted(log.seconds.items())}
    artifact["kinds"] = list(KIND_NAMES)
    artifact["host_phases"] = host_phases
    with open(ARTIFACT, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
    for row in rows:
        row.meta = dict(row.meta or {}, host_phases=host_phases)
    return rows
