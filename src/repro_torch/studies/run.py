"""Study runner of the port: one module per paper table/figure it has.

The counterpart of ``benchmarks/run.py`` for the studies the port carries,
in the reference's order.  On the card by default:

    PYTHONPATH=src python -m repro_torch.studies.run [--quick]
        [--only topology,...] [--device cpu]

Prints ``name,us_per_call,derived`` CSV, as the reference does: ``derived``
carries the reproduced quantity and the paper target it validates against.
A study whose acceptance gate fails raises, and the runner exits non-zero.

The reference's last entry, ``kernels`` (``benchmarks/bench_kernels.py``),
has no counterpart here: it times each kernel against its plain version,
which is benchmark work; ``chip_smoke.py`` holds every kernel of the port
against its plain version on the card.
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time

MODULES = (
    ("validation", "repro_torch.studies.validation"),
    ("topology", "repro_torch.studies.topology"),
    ("routing", "repro_torch.studies.routing"),
    ("snoop_filter", "repro_torch.studies.snoop_filter"),
    ("invblk", "repro_torch.studies.invblk"),
    ("full_duplex", "repro_torch.studies.full_duplex"),
    ("link_layer", "repro_torch.studies.link_layer"),
    ("link_reliability", "repro_torch.studies.link_reliability"),
    ("coherence_fabric", "repro_torch.studies.coherence_fabric"),
    ("telemetry", "repro_torch.studies.telemetry"),
    ("critical_path", "repro_torch.studies.critical_path"),
    ("streaming", "repro_torch.studies.streaming"),
    ("traces", "repro_torch.studies.traces"),
    ("coherence_modes", "repro_torch.studies.coherence_modes"),
    ("fabric", "repro_torch.studies.fabric"),
)


def main(argv=None) -> list:
    """Run the selected studies, print their rows; returns the rows."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="reduced sizes (the reference's --quick)")
    ap.add_argument("--only", type=str, default="",
                    help="comma-separated study names")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    only = {s.strip() for s in args.only.split(",") if s.strip()}
    unknown = only - {name for name, _ in MODULES}
    if unknown:
        # a typo in --only must not silently skip an acceptance gate
        print(f"unknown study names: {sorted(unknown)}", file=sys.stderr)
        sys.exit(2)

    t0 = time.time()
    rows = []
    print("name,us_per_call,derived")
    for name, modname in MODULES:
        if only and name not in only:
            continue
        for r in importlib.import_module(modname).run(quick=args.quick,
                                                      device=args.device):
            print(r.csv(), flush=True)
            rows.append(r)
    print(f"total_wall_s,{time.time() - t0:.1f},")
    return rows


if __name__ == "__main__":
    main()
