"""Fabric-coupled device coherence: isolated-vs-coupled divergence sweep, on
the port.

The counterpart of ``benchmarks/bench_coherence_fabric.py``, row for row.
The §V-B snoop-filter study isolates the DCOH on an infinite bus;
`core.coherence_traffic` lowers the same protocol onto the fabric, so SF
service time feels real congestion: BISnp legs share the device's egress
channel with demand responses and with background demand traffic.

Reported, per victim policy:

  * **SF-capacity x fabric-load sweep**: mean miss latency under the coupled
    model as background load on the device ramps from idle to saturating,
    against the load-independent isolated model.  Gate: the divergence is
    nonzero and grows strictly with load.
  * **BISnp inflation**: mean measured BISnp round trip against the
    analytic ``bisnp_rtt_ps``.
  * **serialized-vs-concurrent fan-out**: mean snooped-miss latency under
    the chain and the fork/join lowerings of one event log as the owner
    count ramps.  Gate: the chain-minus-concurrent divergence grows strictly
    with the owner count.
  * **trace mode** (§V-E): the coupled pipeline on `traces.request_stream`
    workloads (xsbench, silo).

The reference runs each fixpoint iteration's fabric pass as one
``jax.vmap`` of `simulate` over the policies' stacked hop tables; the port
runs it as one `engine.simulate_stacked` (one fused serve-round launch per
round for all policies), and each iteration's SF scans as one
`snoop_filter.simulate_sf_many` (one `sf_scan` launch for all policies).
"""

from __future__ import annotations

import numpy as np

from ..core import topology as T
from ..core import traces
from ..core.coherence_traffic import (CoherenceFabricSpec, coherence_issue,
                                      coupled_fixpoint, lower_coherence)
from ..core.devices import RequesterSpec, build_workload
from ..core.engine import (SimOptions, make_channels, simulate,
                           simulate_stacked, to_host)
from ..core.snoop_filter import (CacheConfig, SFConfig,
                                 make_sequential_stream, make_skewed_stream,
                                 simulate_sf, simulate_sf_many)
from ..core.verify import verify_built, verify_workload
from .common import Row, StudyLog, Timer

POLICIES = ("fifo", "lru", "lfi", "lifo", "mru", "blp")
PORT = 64_000
FIXED = 26_000
N_BG = 3
BG_PAYLOAD = 1024
BG_ROW_CAP = 8_000


def build_coherence_fabric(n_req: int = 2):
    """Star fabric: ``n_req`` coherent requesters + ``N_BG`` background
    requesters + the DCOH device (MEMORY) behind one switch.  Background
    traffic targets the device, so it contends with demand requests,
    demand responses and BISnp legs on the switch<->device channels."""
    kinds = ([T.SWITCH] + [T.REQUESTER] * n_req + [T.MEMORY]
             + [T.REQUESTER] * N_BG)
    dev = n_req + 1
    bgs = list(range(n_req + 2, n_req + 2 + N_BG))
    links = [T.LinkSpec(i, 0, PORT, FIXED) for i in range(1, len(kinds))]
    topo = T.Topology(np.asarray(kinds, np.int64), links, name="cohfab")
    graph = topo.build()
    spec = CoherenceFabricSpec(dev_node=dev,
                               req_nodes=tuple(range(1, n_req + 1)))
    return graph, spec, bgs


def _background(graph, bg_nodes, dev_node, load: float, span_ps: int,
                device="cuda"):
    """Sustained background demand on the device at ``load`` x the device
    link's serialization capacity, spanning the estimated coherent run,
    split over the background requesters (Poisson arrivals).  ``load=0``
    disables background."""
    if load <= 0:
        return None
    ser_ps = BG_PAYLOAD * 1_000_000 // PORT      # one payload's wire time
    interval = max(int(ser_ps * len(bg_nodes) / load), 1)
    n = min(int(span_ps // interval) + 1, BG_ROW_CAP // len(bg_nodes))
    specs = [RequesterSpec(node=b, n_requests=n, targets=[dev_node],
                           read_ratio=0.5, issue_interval_ps=interval,
                           payload_bytes=BG_PAYLOAD, seed=17 + i,
                           issue_jitter="exp")
             for i, b in enumerate(bg_nodes)]
    wl = build_workload(graph, specs, header_bytes=16, warmup_frac=0.0,
                        device=device)
    verify_built(wl, graph).raise_if_failed()
    return wl


def _sf_cfg(policy: str, capacity: int, footprint: int) -> SFConfig:
    return SFConfig(capacity=capacity, policy=policy,
                    invblk_max=2 if policy == "blp" else 1,
                    footprint_lines=footprint)


def coupled_policy_sweep(stream, capacity: int, footprint: int,
                         n_requesters: int, bg_load: float,
                         policies=POLICIES, max_iters: int = 6,
                         tol_ps: int = 0, fanout: str = "concurrent",
                         device="cuda", log=None, name: str = "") -> dict:
    """The coupled fixpoint for every victim policy at once
    (`coherence_traffic.coupled_fixpoint`, one member a policy): each
    iteration one SF scan launch for the policies still iterating and one
    stacked fabric pass over all of them, which must converge.  Returns
    per-policy coupled and isolated metrics, and the fixpoint's ``_meta``;
    ``name`` prefixes the labels of the schedules it records."""
    log = log or StudyLog()
    addr, wr, rid = stream
    graph, spec, bg_nodes = build_coherence_fabric(n_requesters)
    ep = graph.topo.endpoint
    channels = make_channels(graph, ep.row_hit_extra_ps, ep.row_miss_extra_ps,
                             device=device)
    cache = CacheConfig(capacity=capacity)
    cfgs = [_sf_cfg(p, capacity, footprint) for p in policies]

    def scan(ks, fabs):
        with log.phase("sf_scan"):
            return simulate_sf_many([dict(
                addr=addr, is_write=wr, req_id=rid, sf_cfg=cfgs[k],
                cache_cfg=cache, n_requesters=n_requesters, fabric_lat_ps=f,
                return_events=True, device=device)
                for k, f in zip(ks, fabs)])

    isolated = scan(range(len(policies)), [None] * len(policies))
    lows = []
    for cfg, (_, ev) in zip(cfgs, isolated):
        with log.phase("lower"):
            lows.append(lower_coherence(graph, spec, cfg, addr, wr, rid, ev,
                                        fanout=fanout, device=device))
        with log.phase("verify"):
            verify_workload(lows[-1].hops, channels,
                            coherence_issue(lows[-1], ev.fab_issue_ps),
                            sf_events=ev,
                            chan_pair=graph.chan_pair).raise_if_failed()
    span = max(int(res.total_time_ps) for res, _ in isolated)
    with log.phase("lower"):
        background = _background(graph, bg_nodes, spec.dev_node, bg_load,
                                 span, device)
    label = f"{name}load{bg_load:g}/{fanout}/{'+'.join(policies)}"

    def fabric_pass(tag, hops, chans, issue_ps, options):
        sched = log.simulate(f"{label}/{tag}", lambda h, c, i:
                             simulate_stacked(h, c, i, options),
                             hops, chans, issue_ps, stacked=True)
        assert all(sched.converged), "fabric fixpoint did not converge"
        return sched, (False,) * len(policies)

    runs = coupled_fixpoint(scan, isolated, lows, background, channels,
                            SimOptions(check="off"), max_iters, tol_ps,
                            pass_fn=fabric_pass)
    out = {}
    for p, cfg, (iso, _), run in zip(policies, cfgs, isolated, runs):
        m = run.lowering.miss
        lat_iso = to_host(iso.latency_ps)
        lat_cpl = to_host(run.sf.latency_ps)
        bl = to_host(run.bisnp_lat_ps)
        out[p] = {
            "iso_miss_lat_ns": float(lat_iso[m].mean()) / 1e3,
            "cpl_miss_lat_ns": float(lat_cpl[m].mean()) / 1e3,
            "iso_bw_MBps": float(iso.bandwidth_MBps),
            "cpl_bw_MBps": float(run.sf.bandwidth_MBps),
            "bisnp_meas_ns": float(bl[bl > 0].mean()) / 1e3
            if (bl > 0).any() else 0.0,
            "bisnp_model_ns": cfg.bisnp_rtt_ps / 1e3,
        }
    out["_meta"] = {
        "fixpoint_iters": max(r.iters for r in runs),
        "fixpoint_converged": all(r.converged for r in runs),
        "engine_rounds": [int(r.schedule.rounds) for r in runs],
        "engine_converged": all(bool(r.schedule.converged) for r in runs),
    }
    return out


def run_divergence_sweep(n: int = 1200, footprint: int = 1024,
                         capacity: int | None = None,
                         loads=(0.0, 0.3, 0.6, 0.9),
                         policies=POLICIES, device="cuda",
                         log=None) -> list[dict]:
    """Mean coupled miss latency against background load (a fraction of the
    device link's capacity; 0 = no background).  The divergence gate reads
    the fifo column."""
    # capacity at the hot-set size, so capacity victims fire at these sizes
    cap = capacity or int(0.1 * footprint)
    stream = make_skewed_stream(n, footprint, write_ratio=0.2,
                                n_requesters=2, seed=7, device=device)
    rows = []
    for load in loads:
        res = coupled_policy_sweep(stream, cap, footprint, 2, load,
                                   policies=policies, device=device, log=log)
        rows.append({"load": load, "policies": res})
    return rows


def divergence_gate(sweep: list[dict], policy: str = "fifo") -> dict:
    """Isolated-vs-coupled divergence per load level, and the gate."""
    iso = sweep[0]["policies"][policy]["iso_miss_lat_ns"]
    div = [r["policies"][policy]["cpl_miss_lat_ns"] - iso for r in sweep]
    grows = all(b > a for a, b in zip(div, div[1:]))
    return {"divergence_ns": div, "grows_with_load": grows,
            "nonzero": div[-1] > 0}


def run_fanout_sweep(owner_counts=(1, 2, 3, 4), n: int = 600,
                     footprint: int = 256, device="cuda",
                     log=None) -> list[dict]:
    """Serialized-vs-concurrent snoop fan-out divergence against owner
    count: a sequential stream interleaved over R requesters makes every
    SF entry R-way shared, so capacity victims fire R-owner BISnp groups;
    both lowerings of the same event log run on the same fabric."""
    log = log or StudyLog()
    out = []
    for r_cnt in owner_counts:
        graph, spec, _ = build_coherence_fabric(r_cnt)
        ep = graph.topo.endpoint
        channels = make_channels(graph, ep.row_hit_extra_ps,
                                 ep.row_miss_extra_ps, device=device)
        with log.phase("lower"):
            addr, wr, rid = make_sequential_stream(n, footprint,
                                                   n_requesters=r_cnt,
                                                   device=device)
        cap = max(int(0.1 * footprint), 8)
        cfg = SFConfig(capacity=cap, policy="fifo",
                       footprint_lines=footprint)
        with log.phase("sf_scan"):
            _, ev = simulate_sf(addr, wr, rid, cfg,
                                CacheConfig(capacity=cap),
                                n_requesters=r_cnt, return_events=True)
        lat = {}
        rounds = {}
        owners = np.zeros(1)
        mask = to_host(ev.bisnp_mask)
        fab_issue = to_host(ev.fab_issue_ps)
        for fanout in ("chain", "concurrent"):
            with log.phase("lower"):
                low = lower_coherence(graph, spec, cfg, addr, wr, rid, ev,
                                      fanout=fanout, upgrade_bisnp=False,
                                      device=device)
                issue = coherence_issue(low, ev.fab_issue_ps)
            with log.phase("verify"):
                verify_workload(low.hops, channels, issue, sf_events=ev,
                                chan_pair=graph.chan_pair).raise_if_failed()
            sched = log.simulate(f"fanout/owners{r_cnt}/{fanout}", simulate,
                                 low.hops, channels, issue)
            assert sched.converged, f"fanout={fanout} did not converge"
            rounds[fanout] = int(sched.rounds)
            t_req = low.miss.shape[0]
            snooped = low.miss & (mask > 0)
            lat[fanout] = float(np.mean(
                to_host(sched.complete[:t_req])[snooped]
                - fab_issue[snooped]))
            owners = np.array([bin(int(m)).count("1")
                               for m in mask[snooped]])
        out.append({
            "owners": r_cnt,
            "mean_snooped": float(owners.mean()) if owners.size else 0.0,
            "chain_ns": lat["chain"] / 1e3,
            "conc_ns": lat["concurrent"] / 1e3,
            "div_ns": (lat["chain"] - lat["concurrent"]) / 1e3,
            "engine_rounds": rounds,
        })
    return out


def fanout_gate(sweep: list[dict]) -> dict:
    """Chain-minus-concurrent divergence must grow strictly with the
    snooped owner count and be positive once snoops fan out."""
    div = [r["div_ns"] for r in sweep]
    grows = all(b > a for a, b in zip(div, div[1:]))
    return {"divergence_ns": div, "grows_with_owners": grows,
            "nonzero": div[-1] > 0}


def run_trace_mode(names=("xsbench", "silo"), n: int = 800,
                   footprint: int = 1024, load: float = 0.6, device="cuda",
                   log=None) -> dict:
    """§V-E trace workloads through the coupled pipeline (fifo + lifo)."""
    out = {}
    for name in names:
        stream = traces.request_stream(name, n=n, footprint_lines=footprint,
                                       n_requesters=2, seed=3, device=device)
        out[name] = coupled_policy_sweep(stream, int(0.1 * footprint),
                                         footprint, 2, load,
                                         policies=("fifo", "lifo"),
                                         device=device, log=log,
                                         name=f"{name}/")
    return out


def run(quick: bool = False, device="cuda", log=None) -> list[Row]:
    log = log or StudyLog()
    rows: list[Row] = []
    n = 400 if quick else 1200
    footprint = 512 if quick else 1024
    policies = ("fifo", "lru", "lifo", "blp") if quick else POLICIES

    with Timer() as t:
        sweep = run_divergence_sweep(n=n, footprint=footprint,
                                     policies=policies, device=device,
                                     log=log)
    for r in sweep:
        f = r["policies"]["fifo"]
        rows.append(Row(
            f"coherence_fabric/load{r['load']:g}", t.us,
            f"iso_lat={f['iso_miss_lat_ns']:.0f}ns;"
            f"cpl_lat={f['cpl_miss_lat_ns']:.0f}ns;"
            f"bisnp_meas={f['bisnp_meas_ns']:.0f}ns;"
            f"bisnp_model={f['bisnp_model_ns']:.0f}ns",
            meta=r["policies"].get("_meta"),
        ))
    top = sweep[-1]["policies"]
    order = ";".join(f"{p}={top[p]['cpl_miss_lat_ns']:.0f}" for p in policies)
    rows.append(Row("coherence_fabric/policies_at_load", t.us, order))
    gate = divergence_gate(sweep)
    rows.append(Row(
        "coherence_fabric/divergence_gate", t.us,
        f"div_ns={','.join(f'{d:.0f}' for d in gate['divergence_ns'])};"
        f"grows={gate['grows_with_load']};nonzero={gate['nonzero']};"
        f"gate={gate['grows_with_load'] and gate['nonzero']}",
    ))
    assert gate["grows_with_load"] and gate["nonzero"], \
        "isolated-vs-coupled divergence gate failed"

    with Timer() as t:
        fsweep = run_fanout_sweep(owner_counts=(1, 2, 3) if quick
                                  else (1, 2, 3, 4),
                                  n=300 if quick else 600,
                                  footprint=footprint // 2, device=device,
                                  log=log)
    for r in fsweep:
        rows.append(Row(
            f"coherence_fabric/fanout_owners{r['owners']}", t.us,
            f"chain={r['chain_ns']:.0f}ns;conc={r['conc_ns']:.0f}ns;"
            f"div={r['div_ns']:.0f}ns;snooped={r['mean_snooped']:.2f}",
            meta={"engine_rounds": r["engine_rounds"],
                  "engine_converged": True},
        ))
    fgate = fanout_gate(fsweep)
    rows.append(Row(
        "coherence_fabric/fanout_gate", t.us,
        f"div_ns={','.join(f'{d:.0f}' for d in fgate['divergence_ns'])};"
        f"grows={fgate['grows_with_owners']};nonzero={fgate['nonzero']};"
        f"gate={fgate['grows_with_owners'] and fgate['nonzero']}",
    ))
    assert fgate["grows_with_owners"] and fgate["nonzero"], \
        "serialized-vs-concurrent fan-out divergence gate failed"

    with Timer() as t:
        tr = run_trace_mode(n=300 if quick else 800, footprint=footprint,
                            device=device, log=log)
    for name, res in tr.items():
        f = res["fifo"]
        rows.append(Row(
            f"coherence_fabric/trace_{name}", t.us,
            f"iso_lat={f['iso_miss_lat_ns']:.0f}ns;"
            f"cpl_lat={f['cpl_miss_lat_ns']:.0f}ns;"
            f"lifo_cpl={res['lifo']['cpl_miss_lat_ns']:.0f}ns",
            meta=res.get("_meta"),
        ))
    return rows
