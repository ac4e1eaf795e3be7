"""The paper's studies, on the port.

Each module reproduces one file of the reference row for row, on the card
by default (``device="cpu"`` runs the plain PyTorch path):

  * `validation`       — ``benchmarks/bench_validation.py``: Fig. 7 idle
    latency and peak bandwidth vs R:W mix, Fig. 8 loaded latency, the
    Table IV SPEC overhead proxy;
  * `topology`         — ``benchmarks/bench_topology.py``: Fig. 10
    bandwidth vs scale, Fig. 11 latency by hop count, Fig. 12
    ISO-bisection latency;
  * `routing`          — ``benchmarks/bench_routing.py``: Fig. 13
    oblivious, ECMP and adaptive routing under noisy neighbours;
  * `full_duplex`      — ``benchmarks/bench_full_duplex.py``: Fig. 16/17
    duplex mode x header x R:W mix;
  * `link_layer`       — ``benchmarks/bench_link_layer.py``: PCIe 5 vs 6
    generations, the 236/256 flit-efficiency gate, the BER goodput sweep;
  * `link_reliability` — ``benchmarks/bench_link_reliability.py``: zero-BER
    equivalence, the p50/p99 tail sweep of both reliability modes, the
    retraining-stall gate;
  * `traces`           — ``benchmarks/bench_traces.py``: Fig. 18/19 trace
    replay on five fabrics, Fig. 20a/b duplex speedup and mix slope;
  * `snoop_filter`, `invblk`, `coherence_fabric`, `coherence_modes` — Fig.
    14, Fig. 15 and the coherence benchmarks;
  * `telemetry`        — ``benchmarks/bench_telemetry.py``: the metric
    reductions over a BER sweep, with the trace-export row;
  * `critical_path`    — ``benchmarks/bench_critical_path.py``: blame,
    what-ifs and the flow trace on the coherence fabric and the
    reliability bus, and the streamed blame gate;
  * `streaming`        — ``benchmarks/bench_streaming.py``: 1.2M requests
    through 64k-row windows at flat memory, with its equivalence gate;
  * `link_explorer`, `topology_explorer`, `fabric_trace_viewer` —
    ``examples/link_explorer.py``, the fabric parts of
    ``examples/topology_explorer.py``, ``examples/fabric_trace_viewer.py``;
  * `run`              — ``benchmarks/run.py``: the CSV runner over the
    studies above.

The sweeps the reference ``jax.vmap``s run as one `engine.simulate_stacked`
call each.
"""
