"""PCIe 5 vs PCIe 6 flit link layer + BER sensitivity, on the port.

The counterpart of ``benchmarks/bench_link_layer.py``, row for row:

  * **generation comparison** — the §IV validation bus run byte-exact at the
    PCIe 5 effective rate, in 68 B flit mode on the raw PCIe 5 lane rate,
    and in 256 B flit mode on the raw PCIe 6 lane rate;
  * **flit-efficiency check** — a saturated fully packed write stream in
    256 B flit mode at BER 0 must measure the analytic 236/256 payload
    fraction on the requester uplink to < 0.5 % (acceptance gate);
  * **BER sensitivity** — goodput vs bit error rate under Go-Back-N CRC
    replay, one member per BER, resolved by one `simulate_stacked` call
    over the per-channel ``replay_ppm`` table; goodput must fall
    monotonically with BER (acceptance gate).
"""

from __future__ import annotations

import torch

from ..core import topology as T
from ..core.calibration import (PCIE5_X16_MBPS, PCIE5_X16_RAW_MBPS,
                                PCIE6_X16_RAW_MBPS)
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import (channel_stats, request_stats, simulate_auto,
                           simulate_stacked, stack_members,
                           stacked_request_stats)
from ..core.link_layer import (FlitConfig, flit_efficiency,
                               replay_overhead_ppm)
from ..core.verify import verify_built
from .common import Row, StudyLog, Timer

BERS = (0.0, 1e-8, 1e-7, 3e-7, 1e-6, 3e-6, 1e-5)


def _bus_workload(bw_MBps: int, flit, n: int, payload: int = 944,
                  read_ratio: float = 0.0, device="cuda", log=None):
    """§IV validation system, saturated open loop (944 B = 4 full flits)."""
    log = log or StudyLog()
    with log.phase("lower"):
        topo = T.with_flit(T.single_bus(n_mems=4, bw_MBps=bw_MBps), flit)
        g = topo.build()
        spec = RequesterSpec(node=0, n_requests=n, targets=[2, 3, 4, 5],
                             pattern="uniform", read_ratio=read_ratio,
                             issue_interval_ps=100, payload_bytes=payload,
                             seed=11)
        wl = build_workload(g, [spec], header_bytes=64, warmup_frac=0.0,
                            device=device)
    with log.phase("verify"):
        verify_built(wl, g).raise_if_failed()
    return wl


def run_generation(gen: str, n: int = 2500, device="cuda",
                   log=None) -> tuple[float, float]:
    """(goodput MB/s, mean latency ns) of one link-generation config."""
    log = log or StudyLog()
    cfgs = {
        "pcie5_bytes": (PCIE5_X16_MBPS, None),           # the seed's model
        "pcie5_flit68": (PCIE5_X16_RAW_MBPS, FlitConfig("flit68")),
        "pcie6_flit256": (PCIE6_X16_RAW_MBPS, FlitConfig("flit256")),
    }
    bw, flit = cfgs[gen]
    wl = _bus_workload(bw, flit, n, read_ratio=0.5, device=device, log=log)
    sched, _ = log.simulate(f"gen/{gen}", simulate_auto, wl.hops,
                            wl.channels, wl.issue_ps)
    r = request_stats(wl.hops, sched, wl.issue_ps, wl.payload_bytes,
                      wl.measured)
    return float(r["bandwidth_MBps"]), float(r["mean_latency_ps"]) / 1000


def run_efficiency_check(n: int = 2000, device="cuda",
                         log=None) -> tuple[float, float]:
    """(measured uplink efficiency, relative error vs analytic 236/256).

    Write-only traffic with 944 B payloads (4 fully packed 236 B flits) at
    BER 0: every uplink transmission is payload, so channel efficiency —
    logical payload time over wire busy time — is exactly the flit packing
    fraction.
    """
    log = log or StudyLog()
    wl = _bus_workload(PCIE6_X16_RAW_MBPS, FlitConfig("flit256"), n,
                       device=device, log=log)
    sched, _ = log.simulate("flit256_efficiency", simulate_auto, wl.hops,
                            wl.channels, wl.issue_ps)
    c = channel_stats(wl.hops, sched, wl.channels)
    measured = float(c["efficiency"][0])  # requester uplink
    analytic = flit_efficiency("flit256")
    return measured, abs(measured - analytic) / analytic


def run_ber_sweep(bers=BERS, n: int = 1500, device="cuda",
                  log=None) -> list[tuple[float, float]]:
    """[(ber, goodput MB/s)] — one stacked fixpoint over the per-BER
    ``replay_ppm`` tables."""
    log = log or StudyLog()
    wl = _bus_workload(PCIE6_X16_RAW_MBPS, FlitConfig("flit256"), n,
                       read_ratio=0.5, device=device, log=log)
    m = len(bers)
    with log.phase("lower"):
        link = wl.channels.flit_size != 0
        members = [wl.channels._replace(replay_ppm=torch.where(
            link, torch.full_like(wl.channels.replay_ppm,
                                  replay_overhead_ppm(b, "flit256")), 0))
            for b in bers]
        hops = stack_members([wl.hops] * m)
        channels = stack_members(members)
        issue = torch.stack([wl.issue_ps] * m)
    s = log.simulate("ber_sweep", simulate_stacked, hops, channels, issue,
                     stacked=True)
    assert all(s.converged), "BER sweep instance failed to converge"
    stats = stacked_request_stats(hops, s, issue,
                                  torch.stack([wl.payload_bytes] * m),
                                  torch.stack([wl.measured] * m))
    return [(b, float(r["bandwidth_MBps"])) for b, r in zip(bers, stats)]


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    log = log or StudyLog()
    rows: list[Row] = []
    n = 800 if quick else 2500

    base = None
    for gen in ("pcie5_bytes", "pcie5_flit68", "pcie6_flit256"):
        with Timer() as t:
            bw, lat = run_generation(gen, n, device=device, log=log)
        base = base or bw
        rows.append(Row(f"link_layer/gen/{gen}", t.us,
                        f"goodput_MBps={bw:.0f};vs_pcie5={bw / base:.2f};"
                        f"latency_ns={lat:.0f}"))

    with Timer() as t:
        eff, rel_err = run_efficiency_check(max(n, 1000), device=device,
                                            log=log)
    rows.append(Row("link_layer/flit256_efficiency", t.us,
                    f"measured={eff:.4f};analytic={flit_efficiency('flit256'):.4f};"
                    f"rel_err={rel_err:.4f};pass={rel_err < 0.005}"))

    with Timer() as t:
        sweep = run_ber_sweep(BERS[:4] if quick else BERS, n=min(n, 1500),
                              device=device, log=log)
    mono = all(g1 >= g2 for (_, g1), (_, g2) in zip(sweep, sweep[1:]))
    rows.append(Row("link_layer/ber_sweep", t.us,
                    ";".join(f"ber{b:g}={g:.0f}" for b, g in sweep)
                    + f";monotone={mono}"))
    return rows
