#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's main
path (`build_workload` -> `simulate` -> `request_stats`) on the paper's
topology study at scale 16 and on two long traces, checks every schedule
against the port's event-driven oracle, and prints one JSON object per
result line.  The last line is ``{"ok": true, "device": {...}}``; any failed
check raises, so the script exits non-zero and never prints it.  It imports
nothing of JAX and nothing of the ``repro`` package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and the
# non-tensor-core 32-bit rate, the closest listed rate to the kernel's
# integer max/add work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# serve scan, per item: six int64 map components read, one int64 written;
# applying one map to the state is 4 adds + 4 max + 2 saturations
SCAN_BYTES_PER_ITEM = 7 * 8
SCAN_OPS_PER_ITEM = 10

# Rounds the JAX reference needs where the computed `round_bound` falls
# short of them: the ring at scale 16 with 120 requests per pair takes 83
# against a bound of 71 (tests/test_torch_round_bound.py holds the port and
# the reference to it on the CPU).  With the default options such a run is
# unconverged at the bound and `simulate_auto` hands it to the oracle.
REF_ROUNDS = {"ring": 83}
SPIN_CYCLES = 200_000_000  # ~0.1 s of device spin at the H100's clocks
PORT_MBPS = 64_000
FIXED_PS = 26_000
FABRICS = ("chain", "tree", "ring", "spine_leaf", "fully_connected")


def emit(**obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def build_topo(P, kind, n_pairs):
    kw = dict(bw_MBps=PORT_MBPS, fixed_ps=FIXED_PS)
    if kind == "spine_leaf":
        return P.spine_leaf(n_pairs, n_spines=2, per_leaf=min(4, n_pairs),
                            **kw)
    return P.TOPOLOGY_BUILDERS[kind](n_pairs, **kw)


def paper_workload(np, P, topo, n_per_pair, interval_ps, device):
    """The paper's §V-A setup: every requester sends uniform reads to every
    memory; ECMP route choices from a fixed seed."""
    mems = [int(m) for m in topo.memories()]
    specs = [P.RequesterSpec(node=int(r), n_requests=n_per_pair * len(mems),
                             targets=mems, issue_interval_ps=interval_ps,
                             footprint_lines=4096 * len(mems), seed=i)
             for i, r in enumerate(topo.requesters())]
    n_tx = sum(s.n_requests for s in specs)
    rc = np.random.default_rng(17).integers(0, 1 << 20, n_tx)
    return P.build_workload(topo.build(), specs, header_bytes=64,
                            route_choice=rc, device=device)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_cuda(torch, fn, iters):
    """(device ms, host ms) per call.  A spin kernel queued first keeps the
    card busy while the host enqueues every call, so the events time the
    calls' device work alone, not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    h0 = time.perf_counter()
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    host_ms = (time.perf_counter() - h0) * 1e3 / iters
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, host_ms


def scan_bound_ms(k):
    bytes_ms = SCAN_BYTES_PER_ITEM * k / HBM_BYTES_PER_S * 1e3
    ops_ms = SCAN_OPS_PER_ITEM * k / SCALAR_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def round_breakdown(torch, P, ops, K, wl, sched, repeats=5):
    """Device time of each step of one engine round, replayed from the
    resolved schedule (a fixed point, so every repeat does the same work),
    timed with CUDA events; also holds the kernel against the plain version
    on this round's real maps."""
    from repro_torch.core.engine import _round_inputs, _scatter_round

    names = ("sort_gather", "prepass", "scan_kernel", "scatter_propagate",
             "residual_readback")
    total = dict.fromkeys(names, 0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    arrive = sched.arrive
    host = 0.0
    for _ in range(repeats):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        ev[0].record()
        order, args = _round_inputs(wl.hops, wl.channels, arrive)
        ev[1].record()
        maps, aux = ops.serve_maps(*args)
        ev[2].record()
        d_rel = K.serve_scan(*maps)
        ev[3].record()
        s_start, s_depart, _ = ops.finish_round(d_rel, args[3], args[1],
                                                args[11], aux)
        new_arrive = _scatter_round(wl.hops, wl.issue_ps, order, s_start,
                                    s_depart, None)[0]
        ev[4].record()
        resid = int((new_arrive - arrive).abs().max())
        ev[5].record()
        torch.cuda.synchronize()
        host += time.perf_counter() - h0
        check(resid == 0, "replayed round moved a converged schedule")
        for i, n in enumerate(names):
            total[n] += ev[i].elapsed_time(ev[i + 1])
    plain = ops.serve_scan_ref(*maps)
    err = int((d_rel - plain).abs().max())
    check(err == 0, f"kernel != plain version on the main path's maps "
                    f"(K={maps[0].shape[0]}, max abs err {err})")
    out = {n: total[n] / repeats for n in names}
    out["round_host_ms"] = host / repeats * 1e3
    return out, int(maps[0].shape[0]), err


def device_profile(torch, P, wl):
    """Device busy share of one `simulate`: kernel time summed by
    `torch.profiler` over the wall time of the same call, plus the kernels
    that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P.simulate(wl.hops, wl.channels, wl.issue_ps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                top_kernels=[dict(name=e.key[:60], ms=dev_us(e) / 1e3,
                                  calls=e.count) for e in top])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernel_vs_plain(torch, K, ref):
    """The kernel against its plain version on well-formed streams (block
    edges, one segment over many blocks, a long pass-through prefix),
    then its device time at the main path's sizes."""
    blk = K.block_items()
    cases = [dict(k=k) for k in (1, 2, blk - 1, blk, blk + 1, 3 * blk + 5,
                                 (1 << 20) + 7)]
    cases += [dict(k=5 * blk + 3, one_segment=True),
              dict(k=4 * blk + 9, prefix=3 * blk + 17)]
    worst = 0
    for i, case in enumerate(cases):
        k = case.pop("k")
        maps = [torch.from_numpy(m).cuda()
                for m in ref.random_maps(k, 1000 + i, **case)]
        got = K.serve_scan(*maps)
        want = ref.serve_scan_ref(*maps)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, want), f"serve_scan != plain at K={k} {case}")
    emit(phase="kernel_vs_plain", kernel="serve_scan", block_items=blk,
         cases=len(cases), max_abs_err=worst)

    timings = {}
    for k in (268_800, 688_128):
        maps = [torch.from_numpy(m).cuda() for m in ref.random_maps(k, k)]
        ms, host_ms = time_cuda(torch, lambda: K.serve_scan(*maps), 50)
        plain_ms, _ = time_cuda(torch, lambda: ref.serve_scan_ref(*maps), 5)
        bound, by = scan_bound_ms(k)
        timings[k] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by)
        emit(phase="kernel_timing", kernel="serve_scan", K=k, ms=ms,
             host_ms_per_call=host_ms, plain_ms=plain_ms, bound_ms=bound,
             bound_by=by, library_ms=None)
    return worst, timings


def timed(torch, fn):
    """(result, host ms, serve_scan launches) of one main-path call."""
    from repro_torch.kernels.serve_round.kernel import LAUNCHES

    before = LAUNCHES["serve_scan"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            LAUNCHES["serve_scan"] - before)


def run_path(np, torch, P, name, wl):
    """One main-path run on the card: `simulate_auto` with the default
    options (timed), then, where the bound falls short and the oracle
    answered, the fixpoint itself with the reference's round count; stats,
    and the fixpoint's schedule against the oracle.  Returns the fixpoint's
    schedule, its options and the result line."""
    (auto, used_oracle), ms, launches = timed(
        torch, lambda: P.simulate_auto(wl.hops, wl.channels, wl.issue_ps))
    check(launches == auto.rounds,
          f"{name}: {launches} kernel launches for {auto.rounds} rounds")
    check(used_oracle == (name in REF_ROUNDS),
          f"{name}: oracle fallback {used_oracle} after {auto.rounds} rounds")
    row = dict(used_oracle=used_oracle, simulate_ms=ms)
    opts, sched = None, auto
    if used_oracle:
        opts = P.SimOptions(max_rounds=REF_ROUNDS[name])
        sched, fix_ms, fix_launches = timed(
            torch, lambda: P.simulate(wl.hops, wl.channels, wl.issue_ps, opts))
        check(sched.rounds == REF_ROUNDS[name],
              f"{name}: fixpoint took {sched.rounds} rounds, the reference "
              f"{REF_ROUNDS[name]}")
        check(fix_launches == sched.rounds,
              f"{name}: {fix_launches} kernel launches for {sched.rounds} "
              f"rounds")
        launches += fix_launches
        row.update(default_rounds=auto.rounds, fixpoint_ms=fix_ms)
    n, h = wl.hops.channel.shape
    check(sched.converged, f"{name}: not converged in {sched.rounds} rounds")
    check(tuple(sched.arrive.shape) == (n, h + 1), f"{name}: arrive shape")
    check(bool((sched.complete >= wl.issue_ps).all()),
          f"{name}: completion before issue")
    stats = P.request_stats(wl.hops, sched, wl.issue_ps, wl.payload_bytes,
                            wl.measured)
    t0 = time.perf_counter()
    oracle = P.simulate_ref(wl.hops, wl.channels, wl.issue_ps)
    oracle_s = time.perf_counter() - t0
    for f in ("start", "depart", "arrive", "complete"):
        for s in (sched, auto):
            check(np.array_equal(getattr(s, f).cpu().numpy(), oracle[f]),
                  f"{name}: {f} differs from the oracle")
    span = int(sched.complete.max() - wl.issue_ps.min())
    return sched, opts, dict(rows=n, H=h, K=n * h, rounds=sched.rounds,
                             round_bound=P.round_bound(wl.hops),
                             launches=launches, oracle_s=oracle_s,
                             span_ps=span, steady_bandwidth_MBps=int(
                                 stats["steady_bandwidth_MBps"]), **row)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are missing ({src})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import numpy as np

    import repro_torch.core as P
    from repro_torch.kernels import _build
    from repro_torch.kernels.serve_round import kernel as K, ops, ref

    # phase 0: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit(phase="device", name=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # phase 1: build every kernel of the path from this checkout's sources
    t0 = time.perf_counter()
    _build.build_all([K._SOURCE])
    K._lib()
    emit(phase="build", sources=[str(K._SOURCE.relative_to(ROOT))],
         seconds=time.perf_counter() - t0)

    # phase 2: each kernel against its plain version, and its time
    worst, timings = phase_kernel_vs_plain(torch, K, ref)

    # warm up the CUDA libraries on a tiny workload (not part of the run)
    tiny = paper_workload(np, P, build_topo(P, "chain", 2), 2, 500, "cuda")
    P.simulate(tiny.hops, tiny.channels, tiny.issue_ps)
    torch.cuda.synchronize()

    # phases 3-4: the main path, with the launch counts read around it
    K.LAUNCHES["serve_scan"] = 0
    runs = []
    cpu_threads = torch.get_num_threads()
    for fabric in FABRICS:
        wl = paper_workload(np, P, build_topo(P, fabric, 8), 120, 500,
                            "cuda")
        sched, opts, row = run_path(np, torch, P, fabric, wl)
        # the same tables through the port's CPU path
        t0 = time.perf_counter()
        cpu = P.simulate(P.hops_from_arrays(wl.hops, device="cpu"),
                         P.channels_from_arrays(wl.channels, device="cpu"),
                         P.issue_from_array(wl.issue_ps, device="cpu"), opts)
        for f in ("start", "depart", "arrive", "complete"):
            check(torch.equal(getattr(cpu, f), getattr(sched, f).cpu()),
                  f"{fabric}: CPU run differs in {f}")
        check(cpu.rounds == sched.rounds, f"{fabric}: CPU rounds differ")
        row.update(fabric=fabric, cpu_s=time.perf_counter() - t0,
                   cpu_threads=cpu_threads,
                   fig10_norm_bw=row["steady_bandwidth_MBps"] / PORT_MBPS)
        emit(phase="paper_path", **row)
        runs.append((fabric, wl, sched))

    # 4a: past the reference kernel's int32 span (2**29 ps per round)
    tree = build_topo(P, "tree", 8)
    wl = paper_workload(np, P, P.with_flit(tree, P.FlitConfig("flit256")),
                        512, 200_000, "cuda")
    sched, _, row = run_path(np, torch, P, "long_span", wl)
    round_span = int(sched.arrive[:, :-1].max() - sched.arrive[:, :-1].min())
    check(round_span > (1 << 29) - 1, "long-span trace stays inside 2**29 ps")
    emit(phase="long_span", round_span_ps=round_span, **row)
    runs.append(("long_span", wl, sched))

    # 4b: stochastic reliability with link-down markers
    rel = P.FlitConfig("flit256", ber=1e-5, reliability="stochastic",
                       rel_seed=7, retrain_threshold=2,
                       retrain_ps=1_000_000)
    wl = paper_workload(np, P, P.with_flit(tree, rel), 128, 6_000, "cuda")
    markers = int(P.link_layer.retrain_marker_mask(
        wl.hops.channel.cpu().numpy(), wl.hops.nbytes.cpu().numpy(),
        wl.hops.valid.cpu().numpy(),
        wl.hops.retrain_after_ps.cpu().numpy()).sum())
    check(markers > 0, "the stochastic trace has no link-down markers")
    sched, _, row = run_path(np, torch, P, "markers", wl)
    emit(phase="markers", markers=markers, **row)
    runs.append(("markers", wl, sched))
    launches = K.LAUNCHES["serve_scan"]
    check(launches > 0, "the main path never launched serve_scan")

    # where one round's time goes, per workload (after the counts are read)
    for name, wl, sched in runs:
        steps, k, err = round_breakdown(torch, P, ops, K, wl, sched)
        worst = max(worst, err)
        emit(phase="round_breakdown", workload=name, K=k, **steps)
        if name in ("chain", "long_span"):
            emit(phase="device_profile", workload=name,
                 **device_profile(torch, P, wl))

    main_k = 268_800
    t = timings[main_k]
    emit(kernels=[dict(
        name="serve_scan", route="cuda",
        source="src/repro_torch/kernels/serve_round/csrc/serve_round.cu",
        replaces="src/repro/kernels/serve_round/kernel.py:104",
        launches=launches, max_abs_err=worst, ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None, K=main_k)])

    leaked = sorted(m for m in sys.modules if m in ("jax", "repro")
                    or m.startswith(("jax.", "jaxlib", "repro.")))
    check(not leaked, f"imported JAX or the reference package: {leaked}")
    emit(ok=True, device=dict(platform="gpu", kind=kind,
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
