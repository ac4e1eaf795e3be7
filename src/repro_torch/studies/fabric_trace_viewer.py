"""Export a Perfetto-loadable timeline of the coherence fabric demo, on the
port.

The counterpart of ``examples/fabric_trace_viewer.py``, line for line of
its printout: runs the fabric-coupled coherence scenario (coherent
requesters + Poisson background demand sharing one DCOH device behind a
switch; every SF scan through `kernels.sf_scan`, every fabric pass through
the fused serve round on the card), then renders the converged schedule
with `core.trace_export`:

  * one track per fabric channel (BISnp legs, demand responses and
    background payloads as duration events, FCFS queue wait in ``args``);
  * per-channel link-down tracks when stochastic retraining is enabled;
  * the coupled fixpoint's per-iteration residual as a counter series.

Open the output in https://ui.perfetto.dev (or ``chrome://tracing``):

    PYTHONPATH=src python -m repro_torch.studies.fabric_trace_viewer \\
        [--out trace.json] [--quick] [--device cpu]

A latency-attribution summary (where each request's time went, p50/p99/
p99.9 from the streaming sketch) prints alongside, from `core.telemetry`.
"""

from __future__ import annotations

import argparse

from ..core import telemetry as tm
from ..core import trace_export as tx
from ..core.coherence_traffic import simulate_coupled
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import make_channels, to_host
from ..core.snoop_filter import (CacheConfig, SFConfig, make_skewed_stream,
                                 simulate_sf)
from .coherence_fabric import BG_PAYLOAD, PORT, build_coherence_fabric

FOOTPRINT = 512
CAP = FOOTPRINT // 10


def run_scenario(n: int, load: float = 0.6, device="cuda"):
    # the coherence demo's star: 2 coherent requesters, the DCOH device
    # and 3 background requesters behind one switch
    graph, spec, bg_nodes = build_coherence_fabric(2)
    addr, wr, rid = make_skewed_stream(n, FOOTPRINT, write_ratio=0.2,
                                       n_requesters=2, seed=7, device=device)
    cfg = SFConfig(capacity=CAP, policy="fifo", footprint_lines=FOOTPRINT)
    cache = CacheConfig(capacity=CAP)
    iso = simulate_sf(addr, wr, rid, cfg, cache, n_requesters=2)
    bg = None
    if load > 0:
        interval = max(int(BG_PAYLOAD * 1_000_000 // PORT
                           * len(bg_nodes) / load), 1)
        n_bg = min(int(iso.total_time_ps) // interval + 1, 3_000)
        bg = build_workload(graph, [
            RequesterSpec(node=b, n_requests=n_bg, targets=[spec.dev_node],
                          read_ratio=0.5, issue_interval_ps=interval,
                          payload_bytes=BG_PAYLOAD, seed=17 + i,
                          issue_jitter="exp")
            for i, b in enumerate(bg_nodes)], header_bytes=16,
            warmup_frac=0.0, device=device)
    res = simulate_coupled(addr, wr, rid, cfg, cache, graph, spec,
                           n_requesters=2, background=bg, max_iters=10,
                           tol_ps=1_000, device=device)
    return res, graph


def print_attribution(res, graph) -> None:
    dev = res.schedule.arrive.device
    ch = make_channels(graph, device=dev)
    att = tm.attribute_latency(res.fabric_hops, ch, res.schedule,
                               res.fabric_issue_ps)
    assert int(tm.conservation_residual(att).abs().max()) == 0
    total = int(att.total_ps.sum())
    print("== where the latency went (all scheduled rows) ==")
    for name, field in (("join/fork wait", att.join_wait_ps),
                        ("FCFS queueing", att.queue_wait_ps),
                        ("retrain stall", att.retrain_stall_ps),
                        ("wire serialization", att.wire_ps),
                        ("row-buffer extras", att.row_extra_ps),
                        ("fixed latency", att.fixed_ps)):
        v = int(field.sum())
        print(f"  {name:20s} {v / 1e6:10.1f} us  ({100 * v / total:5.1f}%)")
    sk = tm.sketch_update(tm.sketch_new(dev), att.total_ps)
    p50, p99, p999 = (int(x) for x in to_host(tm.sketch_quantiles(sk)))
    print(f"  latency p50/p99/p99.9: {p50 / 1e3:.0f} / {p99 / 1e3:.0f} /"
          f" {p999 / 1e3:.0f} ns")
    ct = tm.channel_telemetry(res.fabric_hops, ch, res.schedule)
    util = to_host(ct.utilization)
    names = tx.channel_names(graph)
    hot = int(util.argmax())
    print(f"  hottest channel: {names[hot]} at {100 * util[hot]:.1f}% "
          f"(peak backlog {int(ct.peak_backlog[hot])})")
    print(f"  coupled fixpoint: {res.iters} iters"
          f"{'' if res.converged else ' (cap)'}, residuals "
          f"{[int(x) for x in res.residual_ps]} ps")


def main(argv=None) -> dict:
    """Run the scenario, print the summary, write the trace; returns the
    trace dict."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="trace.json",
                    help="output path for the Chrome-trace JSON")
    ap.add_argument("--quick", action="store_true",
                    help="smaller scenario (n 200 instead of 600)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    res, graph = run_scenario(n=200 if args.quick else 600,
                              device=args.device)
    print_attribution(res, graph)

    trace = tx.coupled_trace(res, graph)
    errs = tx.validate_trace(trace)
    assert errs == [], f"exported trace failed validation: {errs[:3]}"
    tx.write_trace(trace, args.out)
    n_ev = sum(1 for e in trace["traceEvents"] if e["ph"] != "M")
    print(f"\nwrote {args.out}: {n_ev} events on "
          f"{graph.n_channels} channel tracks "
          f"- load it at https://ui.perfetto.dev")
    return trace


if __name__ == "__main__":
    main()
