"""Link-layer design-space exploration: flit modes, BER, rx credits.

The counterpart of ``examples/link_explorer.py`` on the port: it walks the
knobs the PCIe 6.0 flit link layer adds on top of a single bandwidth
constant, on a spine-leaf fabric, and evaluates the flit-efficiency grid
with the `flit_sweep` kernel.  On the card by default:

    PYTHONPATH=src python -m repro_torch.studies.link_explorer [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.calibration import PCIE5_X16_MBPS, PCIE6_X16_RAW_MBPS
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import request_stats, simulate_auto
from ..core.link_layer import (FlitConfig, credit_limited_MBps,
                               goodput_efficiency)
from ..core.topology import spine_leaf, with_flit
from ..kernels.flit_pack.ops import flit_sweep


def run_fabric(flit, label: str, scale: int = 4, device="cuda") -> None:
    topo = with_flit(spine_leaf(scale, per_leaf=2,
                                bw_MBps=PCIE6_X16_RAW_MBPS), flit)
    g = topo.build()
    mems = [int(m) for m in topo.memories()]
    specs = [RequesterSpec(node=int(r), n_requests=120 * len(mems),
                           targets=mems, issue_interval_ps=400,
                           payload_bytes=944, read_ratio=0.5, seed=i)
             for i, r in enumerate(topo.requesters())]
    wl = build_workload(g, specs, header_bytes=64, warmup_frac=0.25,
                        device=device)
    sched, oracle = simulate_auto(wl.hops, wl.channels, wl.issue_ps)
    r = request_stats(wl.hops, sched, wl.issue_ps, wl.payload_bytes,
                      wl.measured)
    print(f"  {label:28s} goodput {float(r['steady_bandwidth_MBps'])/1000:8.1f}"
          f" GB/s   mean latency {float(r['mean_latency_ps'])/1000:6.0f} ns"
          f"{'   (oracle)' if oracle else ''}")


def flit_mode_sweep(device="cuda") -> None:
    print("== spine-leaf fabric: link generations (PCIe 6 raw lanes) ==")
    run_fabric(None, "byte-exact (seed model)", device=device)
    run_fabric(FlitConfig("flit68"), "68 B flits (PCIe 5 / CXL 2.0)",
               device=device)
    run_fabric(FlitConfig("flit256"), "256 B flits (PCIe 6 / CXL 3.x)",
               device=device)


def ber_sweep(device="cuda") -> None:
    print("\n== 256 B flit goodput efficiency vs BER (Go-Back-N replay) ==")
    for ber in (0.0, 1e-8, 1e-7, 1e-6, 1e-5):
        eff = goodput_efficiency("flit256", ber)
        run_fabric(FlitConfig("flit256", ber=ber),
                   f"BER {ber:g} (analytic eff {eff:.3f})", device=device)


def credit_sweep(device="cuda") -> None:
    print("\n== rx-credit cap on a PCIe 6 x16 lane (100 ns credit loop) ==")
    for credits in (8, 16, 32, 64, 128, 256):
        cfg = FlitConfig("flit256", rx_credits=credits)
        cap = credit_limited_MBps(PCIE6_X16_RAW_MBPS, cfg)
        bind = "  <- credit-bound" if cap < PCIE6_X16_RAW_MBPS else ""
        print(f"  {credits:4d} credits: effective {cap/1000:7.1f} GB/s{bind}")
    run_fabric(FlitConfig("flit256", rx_credits=16),
               "fabric @ 16 credits", device=device)


KERNEL_GRID_PAYLOADS = (64, 236, 472, 944, 4096)
KERNEL_GRID_BERS = (0.0, 1e-7, 1e-6, 1e-5)


def kernel_grid(device="cuda") -> np.ndarray:
    """Print and return the (mode x BER) mean goodput-fraction grid of
    `flit_sweep` over a packet-size mix."""
    print("\n== flit_pack kernel: packet-size x BER efficiency grid ==")
    pays = np.asarray(KERNEL_GRID_PAYLOADS)
    bers = KERNEL_GRID_BERS
    grid = flit_sweep(pays, ["flit68", "flit256"], bers,
                      device=device).cpu().numpy()
    print(f"  payload mix {pays.tolist()} B, mean goodput fraction:")
    for mode, row in zip(("flit68 ", "flit256"), grid):
        cells = "  ".join(f"{v:.3f}" for v in row)
        print(f"  {mode}  ber {list(bers)} -> {cells}")
    return grid


def main(device="cuda") -> None:
    flit_mode_sweep(device)
    ber_sweep(device)
    credit_sweep(device)
    kernel_grid(device)
    print(f"\n(PCIe 5 effective constant was {PCIE5_X16_MBPS/1000:.0f} GB/s — "
          "the whole link layer the seed collapsed into one number.)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
