"""The link-layer design study, on the port.

Each module reproduces one file of the reference row for row, on the card
by default (``device="cpu"`` runs the plain PyTorch path):

  * `link_layer`       — ``benchmarks/bench_link_layer.py``: PCIe 5 vs 6
    generations, the 236/256 flit-efficiency gate, the BER goodput sweep;
  * `link_reliability` — ``benchmarks/bench_link_reliability.py``: zero-BER
    equivalence, the p50/p99 tail sweep of both reliability modes, the
    retraining-stall gate;
  * `link_explorer`    — ``examples/link_explorer.py``: flit modes, BER and
    rx credits on a spine-leaf fabric, and the `flit_sweep` kernel grid.

The sweeps the reference ``jax.vmap``s run as one `engine.simulate_stacked`
call each.
"""
