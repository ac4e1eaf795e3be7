"""Paper §IV validation on the port: idle latency, peak bandwidth vs R:W mix,
loaded-latency curves (Fig. 7/8) and the SPEC CPU2017 overhead proxy
(Table IV).

The counterpart of ``benchmarks/bench_validation.py``, row for row.  Three
platforms are modeled, mirroring the paper's hardware testbed:

  local   CPU -> memory-controller hub -> 4x DDR5 DIMM endpoints.  The DDR
          data bus is half-duplex with a write<->read turnaround, which is why
          hardware DRAM bandwidth *falls* as writes mix in.
  numa    same, behind a UPI-like half-duplex socket interconnect (+fixed hop).
  cxl     requester -> PCIe5/CXL switch port -> MXC expander with 4 DIMMs.
          Full-duplex link with 16B CXL.mem header slots; effective per-
          direction link bandwidth 26 GB/s (MXC controller efficiency, cf.
          Sun et al. MICRO'23), which is why CXL bandwidth *rises* with mix.

Latency constants are Table III; references are `calibration.REFERENCE_HW`.
The study reports relative errors against the same acceptance bands the paper
claims (bandwidth 0.1-10%, loaded latency <=12%).
"""

from __future__ import annotations

import numpy as np

from ..core import topology as T
from ..core.calibration import (CAL, DRAM_ROW_HIT_PS, DRAM_ROW_MISS_PS,
                                REFERENCE_HW, TABLE_IV)
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import request_stats, to_host
from ..core.verify import verify_built
from .common import Row, StudyLog, Timer, simulate_exact

PLATFORMS = {
    # bus_MBps, duplex, turnaround_ps, link_fixed_ps, header, n_hubs(=switch)
    "local": dict(bus=118_000, duplex="half", turn=300, fixed=1_500, header=0,
                  extra_fixed=0),
    "numa": dict(bus=50_000, duplex="half", turn=700, fixed=1_500, header=0,
                 extra_fixed=41_000),
    "cxl": dict(bus=26_000, duplex="full", turn=0, fixed=26_000, header=16,
                extra_fixed=0),
}
# Fig. 8's injection intervals (ps), lightest load first
LOADED_IVS = (60_000, 24_000, 12_000, 6_000, 4_000, 3_400, 3_000,
              2_800, 2_700, 2_620, 2_560, 2_510)


def build_platform(name: str) -> tuple[T.Topology, dict]:
    p = PLATFORMS[name]
    # DDR5 DIMM: 32 banks (x2 ranks folded in); tCAS ~15ns per access, row
    # activate+precharge adds ~40ns more on a row switch
    ep = T.EndpointSpec(bw_MBps=38_400, fixed_ps=CAL.device_controller_ps,
                        banks=32, row_hit_extra_ps=DRAM_ROW_HIT_PS,
                        row_miss_extra_ps=DRAM_ROW_HIT_PS + DRAM_ROW_MISS_PS)
    kinds = [T.REQUESTER, T.SWITCH] + [T.MEMORY] * 4
    links = [T.LinkSpec(0, 1, p["bus"], p["fixed"] + p["extra_fixed"],
                        p["duplex"], p["turn"])]
    for m in range(4):
        links.append(T.LinkSpec(1, 2 + m, p["bus"], p["fixed"],
                                p["duplex"], p["turn"]))
    sw_ps = CAL.switching_ps if name == "cxl" else 2_000
    topo = T.Topology(np.asarray(kinds, np.int64), links, name=name,
                      endpoint=ep, switching_ps=sw_ps)
    return topo, p


def measure(name: str, read_ratio: float, interval_ps: int, n: int = 3000,
            pattern: str = "stream", jitter: str = "none", device="cuda",
            log=None):
    """MLC-style measurement: bandwidth tests stream sequentially (row-buffer
    friendly, like MLC's --peak_injection_bandwidth); idle-latency tests use
    dependent random loads (pattern="uniform", every access a row miss).
    Returns (mean latency ns, bandwidth GB/s)."""
    log = log or StudyLog()
    with log.phase("lower"):
        topo, p = build_platform(name)
        graph = topo.build()
        spec = RequesterSpec(node=0, n_requests=n, targets=[2, 3, 4, 5],
                             pattern=pattern, read_ratio=read_ratio,
                             issue_interval_ps=interval_ps,
                             issue_jitter=jitter, footprint_lines=1 << 18,
                             seed=7)
        # warmup 0 + span-based bandwidth: conservation-exact for mixed
        # traffic (percentile-window estimates are distorted by type-phase
        # completion bunching)
        wl = build_workload(graph, [spec], header_bytes=p["header"],
                            warmup_frac=0.0, device=device)
    with log.phase("verify"):
        verify_built(wl, graph).raise_if_failed()
    sched, _ = log.simulate(f"{name}/rr{read_ratio:g}/iv{interval_ps}/n{n}/"
                            f"{pattern}/{jitter}", simulate_exact, wl.hops,
                            wl.channels, wl.issue_ps)
    r = request_stats(wl.hops, sched, wl.issue_ps, wl.payload_bytes,
                      wl.measured)
    meas = to_host(wl.measured)
    lat_ns = float(to_host(r["latency_ps"])[meas].mean()) / 1000.0
    bw_GBs = float(r["bandwidth_MBps"]) / 1000.0
    return lat_ns, bw_GBs


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    log = log or StudyLog()
    rows: list[Row] = []
    n = 1000 if quick else 4000

    # ---- Fig. 7 left: idle latency --------------------------------------
    for name, ref_key in (("local", "local_dram"), ("numa", "remote_numa_dram"),
                          ("cxl", "cxl_mxc")):
        with Timer() as t:
            lat, _ = measure(name, 1.0, 700_000, n=300, pattern="uniform",
                             device=device, log=log)
        ref = REFERENCE_HW["idle_latency_ns"][ref_key]
        rows.append(Row(
            f"fig7/idle_latency/{name}", t.us,
            f"sim={lat:.0f}ns;hw={ref:.0f}ns;rel_err={abs(lat - ref) / ref:.3f}",
        ))

    # ---- Fig. 7 right: peak bandwidth vs R:W ratio ----------------------
    for name, ref_key in (("local", "local_dram"), ("numa", "remote_numa_dram"),
                          ("cxl", "cxl_mxc")):
        refs = REFERENCE_HW["peak_bw_GBs"][ref_key]
        for (rr, ww), ref in zip(REFERENCE_HW["rw_ratios"], refs):
            ratio = rr / (rr + ww)
            with Timer() as t:
                _, bw = measure(name, ratio, 150, n=n, device=device, log=log)
            rows.append(Row(
                f"fig7/peak_bw/{name}/rw{rr}to{ww}", t.us,
                f"sim={bw:.1f}GBs;hw={ref:.1f}GBs;rel_err={abs(bw - ref) / ref:.3f}",
            ))

    # ---- Fig. 8: loaded latency (CXL reads) ------------------------------
    curve = []
    for iv in LOADED_IVS:
        with Timer() as t:
            # Poisson arrivals: MLC loaded-latency traffic is stochastic;
            # deterministic intervals would give a step-function knee
            lat, bw = measure("cxl", 1.0, iv, n=n, pattern="uniform",
                              jitter="exp", device=device, log=log)
        curve.append((bw, lat))
        rows.append(Row(f"fig8/loaded/cxl_read/iv{iv}", t.us,
                        f"bw={bw:.1f}GBs;lat={lat:.0f}ns"))
    errs = []
    xs = np.array([c[0] for c in curve])
    ys = np.array([c[1] for c in curve])
    o = np.argsort(xs)
    for ref_bw, ref_lat in REFERENCE_HW["loaded_latency_cxl_read"]:
        sim_lat = float(np.interp(ref_bw, xs[o], ys[o]))
        errs.append(abs(sim_lat - ref_lat) / ref_lat)
    rows.append(Row(
        "fig8/loaded/error_summary", 0.0,
        f"avg_rel_err={np.mean(errs):.3f};max_rel_err={np.max(errs):.3f};"
        f"paper_band_avg={REFERENCE_HW['paper_error_bands']['loaded_latency_rel_err_avg']};"
        f"paper_band_max={REFERENCE_HW['paper_error_bands']['loaded_latency_rel_err_max']}",
    ))

    # ---- Table IV: SPEC CPU2017 overhead proxy ---------------------------
    # Execution time = instrs*CPI + LLC-misses * effective latency * (1-MLP).
    # (mpki, cpi_ns, mlp_overlap) calibrated per workload; the *platform
    # latencies are simulated*, so the overhead error tracks sim accuracy.
    spec_params = {"gcc": (0.9, 0.30, 0.53), "mcf": (8.0, 0.25, 0.938)}
    lat_local, _ = measure("local", 1.0, 700_000, n=300, pattern="uniform",
                           device=device, log=log)
    lat_cxl, _ = measure("cxl", 1.0, 700_000, n=300, pattern="uniform",
                         device=device, log=log)
    for wlname, (mpki, cpi, mlp) in spec_params.items():
        n_instr = 1e6
        misses = mpki * n_instr / 1000
        exec_local = n_instr * cpi + misses * lat_local * (1 - mlp)
        exec_cxl = n_instr * cpi + misses * lat_cxl * (1 - mlp)
        ovh = exec_cxl / exec_local - 1
        hw = TABLE_IV["CXL Hardware"][wlname]
        esf = TABLE_IV["ESF standalone"][wlname]
        rows.append(Row(
            f"tab4/spec_overhead/{wlname}", 0.0,
            f"sim={ovh:.3f};hw={hw:.3f};paper_esf={esf:.3f};"
            f"delta_vs_hw={abs(ovh - hw):.3f}",
        ))
    return rows
