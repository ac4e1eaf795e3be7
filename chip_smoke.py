#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, and drives the port's
paths through them:

  * the main path (`build_workload` -> `simulate` -> `request_stats`) on the
    paper's topology study at scale 16 and on two long traces (serve-scan
    kernel);
  * the link-layer studies (`studies.link_layer`, `studies.link_reliability`)
    at the reference benchmarks' full sizes, their sweeps stacked
    (`simulate_stacked`: one serve-scan launch per round for all members);
  * `depart_times` (segmented depart kernel) on the converged rounds of the
    paper fabrics and of every expected-mode sweep member, against the
    serve-scan kernel's departures;
  * the link explorer's flit-efficiency grid (`flit_sweep`, flit-pack
    kernel).

Every schedule is checked against the port's event-driven oracle, and the
script prints one JSON object per result line.  The last line is ``{"ok": true, "device": {...}}``; any failed
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
# segmented depart, per item: int64 channel, arrive and ser read, depart
# written (28 B with an int32 channel); a head test, an add and a max
DEPART_BYTES_PER_ITEM = 4 * 8
DEPART_OPS_PER_ITEM = 3
# flit pack, per point: four int32 reads, an int32 and a float32 write;
# ceil division, multiply, select, three float multiply/adds, max, divide
FLIT_BYTES_PER_ITEM = 6 * 4
FLIT_OPS_PER_ITEM = 8

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


def bound_ms(k, bytes_per_item, ops_per_item):
    """(least time on the card in ms, what bounds it) for k items."""
    bytes_ms = bytes_per_item * k / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_per_item * k / SCALAR_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def scan_bound_ms(k):
    return bound_ms(k, SCAN_BYTES_PER_ITEM, SCAN_OPS_PER_ITEM)


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


def phase_depart_vs_plain(torch, LK, LR):
    """The segmented depart kernel against its plain version (block edges,
    one segment over many blocks, one-item segments, a leading channel -1
    run, int32 channels, K to 2**20 + 7), then its time at the main path's
    sizes."""
    blk = LK.block_items()
    cases = [dict(k=k) for k in (1, 2, blk - 1, blk, blk + 1, 3 * blk + 5,
                                 (1 << 20) + 7)]
    cases += [dict(k=5 * blk + 3, one_segment=True),
              dict(k=4 * blk + 9, singletons=True),
              dict(k=3 * blk + 1, lead_minus_one=blk + 17),
              dict(k=2 * blk + 11, offset=7 << 40)]
    worst = 0
    for i, case in enumerate(cases):
        kw = dict(case)
        cols = [torch.from_numpy(x).cuda()
                for x in LR.random_stream(kw.pop("k"), 2000 + i, **kw)]
        want = LR.segmented_depart_ref(*cols)
        for chan in (cols[0], cols[0].int()):
            got = LK.segmented_depart(chan, *cols[1:])
            torch.cuda.synchronize()
            worst = max(worst, int((got - want).abs().max()))
            check(torch.equal(got, want),
                  f"segmented_depart != plain for {case} ({chan.dtype})")
    emit(phase="kernel_vs_plain", kernel="segmented_depart", block_items=blk,
         cases=2 * len(cases), max_abs_err=worst)

    timings = {}
    for k in (268_800, 688_128):
        cols = [torch.from_numpy(x).cuda()
                for x in LR.random_stream(k, k, n_chan=600)]
        chan32 = cols[0].int()
        ms, host_ms = time_cuda(torch, lambda: LK.segmented_depart(*cols), 50)
        ms32, _ = time_cuda(torch, lambda: LK.segmented_depart(
            chan32, *cols[1:]), 50)
        plain_ms, _ = time_cuda(torch,
                                lambda: LR.segmented_depart_ref(*cols), 5)
        bound, by = bound_ms(k, DEPART_BYTES_PER_ITEM, DEPART_OPS_PER_ITEM)
        timings[k] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by)
        emit(phase="kernel_timing", kernel="segmented_depart", K=k, ms=ms,
             ms_int32_channel=ms32, host_ms_per_call=host_ms,
             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
             library_ms=None)
    return worst, timings


def phase_flit_vs_plain(np, torch, FK, FR, max_payload, max_ppm):
    """The flit-pack kernel against its plain version (block edges, every
    flit mode, ppm over its whole range, payloads up to MAX_PAYLOAD_B),
    then its time on 2**20 and 2**24 points."""
    def points(k, seed):
        rng = np.random.default_rng(seed)
        pay = rng.integers(0, max_payload + 1, k)
        pay[: k // 2] = rng.integers(0, 1 << 16, k // 2)
        pay[:4] = (0, 1, 236, max_payload)[:k]
        # byte-exact, flit68 and flit256 points
        fsize = rng.choice([0, 68, 256], k)
        fpay = np.where(fsize == 68, 64, np.where(fsize == 256, 236, 0))
        ppm = rng.integers(0, max_ppm + 1, k)
        ppm[:2] = (0, max_ppm)[:k]
        return [torch.from_numpy(x.astype(np.int32)).cuda()
                for x in (pay, fsize, fpay, ppm)]

    worst = 0.0
    sizes = (1, 2, 255, 256, 257, 256 * 132 * 32 + 1, (1 << 20) + 3)
    for i, k in enumerate(sizes):
        cols = points(k, 3000 + i)
        wire, eff = FK.flit_pack_kernel(*cols)
        w_ref, e_ref = FR.flit_pack_ref(*cols)
        torch.cuda.synchronize()
        worst = max(worst, float((wire - w_ref).abs().max()),
                    float((eff - e_ref).abs().max()))
        check(torch.equal(wire, w_ref) and torch.equal(eff, e_ref),
              f"flit_pack != plain at K={k}")
    emit(phase="kernel_vs_plain", kernel="flit_pack", cases=len(sizes),
         max_abs_err=worst)

    timings = {}
    for k in (1 << 20, 1 << 24):
        cols = points(k, k)
        ms, host_ms = time_cuda(torch, lambda: FK.flit_pack_kernel(*cols),
                                50)
        plain_ms, _ = time_cuda(torch, lambda: FR.flit_pack_ref(*cols), 5)
        bound, by = bound_ms(k, FLIT_BYTES_PER_ITEM, FLIT_OPS_PER_ITEM)
        timings[k] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by)
        emit(phase="kernel_timing", kernel="flit_pack", K=k, ms=ms,
             host_ms_per_call=host_ms, plain_ms=plain_ms, bound_ms=bound,
             bound_by=by, library_ms=None)
    return worst, timings


def check_study_runs(np, P, name, log):
    """Every schedule a study resolved — each member of a stacked sweep —
    against the port's oracle; a stacked sweep launches the serve scan once
    per round for all its members."""
    members = 0
    for run in log.runs:
        rounds = run.schedule.rounds
        if run.stacked:
            check(run.launches == max(rounds),
                  f"{name}/{run.label}: {run.launches} serve_scan launches "
                  f"for {max(rounds)} stacked rounds")
            tables = [(P.member(run.hops, i), P.member(run.channels, i),
                       P.member(run.issue_ps, i), P.member(run.schedule, i))
                      for i in range(len(rounds))]
        else:
            check(run.launches == rounds,
                  f"{name}/{run.label}: {run.launches} serve_scan launches "
                  f"for {rounds} rounds")
            tables = [(run.hops, run.channels, run.issue_ps, run.schedule)]
        for i, (hops, ch, issue, sched) in enumerate(tables):
            check(sched.converged, f"{name}/{run.label}[{i}] not converged")
            oracle = P.simulate_ref(hops, ch, issue)
            for f in ("start", "depart", "arrive", "complete"):
                check(np.array_equal(getattr(sched, f).cpu().numpy(),
                                     oracle[f]),
                      f"{name}/{run.label}[{i}]: {f} differs from the "
                      f"oracle")
            members += 1
    return members


def run_study(np, torch, P, K, module, name):
    """One study at the reference's full size on the card: rows, host time
    by phase, every schedule against the oracle."""
    from repro_torch.studies.common import StudyLog

    log = StudyLog(sync=torch.cuda.synchronize,
                   launches=lambda: K.LAUNCHES["serve_scan"])
    t0 = time.perf_counter()
    rows = module.run(quick=False, device="cuda", log=log)
    total_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    members = check_study_runs(np, P, name, log)
    for row in rows:
        emit(phase="study_row", study=name, name=row.name,
             us_per_call=row.us_per_call, derived=row.derived)
    emit(phase="study", study=name, host_s=total_s,
         lower_s=log.seconds.get("lower", 0.0),
         verify_s=log.seconds.get("verify", 0.0),
         simulate_s=log.seconds.get("simulate", 0.0),
         rounds={r.label: r.schedule.rounds for r in log.runs},
         members_checked=members, oracle_s=time.perf_counter() - t0)
    return rows, log


def stacked_vs_loop(torch, P, run):
    """Host ms of one stacked sweep against its members run one by one
    (each call ends in a host readback), three times in turns."""
    m = len(run.schedule.rounds)
    stacked, loop = [], []
    for _ in range(3):
        for out, fn in ((stacked, lambda: P.simulate_stacked(
                run.hops, run.channels, run.issue_ps)),
                (loop, lambda: [P.simulate(P.member(run.hops, i),
                                           P.member(run.channels, i),
                                           P.member(run.issue_ps, i))
                                for i in range(m)])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return dict(members=m, rounds=list(run.schedule.rounds),
                stacked_ms=stacked, one_by_one_ms=loop)


def depart_on_round(torch, P, LO, name, hops, channels, sched):
    """`depart_times` over one replayed converged round's serving items
    against the serve-scan kernel's departures for those items."""
    from repro_torch.core.engine import _round_inputs
    from repro_torch.kernels.serve_round.ops import serve_round

    check(int(channels.turnaround_ps.abs().max()) == 0
          and int(channels.row_hit_ps.abs().max()) == 0
          and int(channels.row_miss_ps.abs().max()) == 0,
          f"{name}: channels with turnaround or DRAM row timing")
    _, args = _round_inputs(hops, channels, sched.arrive)
    serving, marker = args[1], args[2]
    check(not bool(marker.any()), f"{name}: link-down markers in the round")
    _, depart, _ = serve_round(*args)
    got = LO.depart_times(args[0][serving], args[3][serving],
                          args[6][serving])
    want = depart[serving]
    torch.cuda.synchronize()
    err = int((got - want).abs().max()) if got.numel() else 0
    check(torch.equal(got, want),
          f"{name}: depart_times != serve-scan depart (max abs err {err})")
    return int(serving.sum()), err


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
    from repro_torch.kernels.flit_pack import kernel as FK, ref as FR
    from repro_torch.kernels.flit_pack.ops import MAX_PAYLOAD_B
    from repro_torch.kernels.link_contention import kernel as LK, ref as LR
    from repro_torch.kernels.link_contention import ops as LO
    from repro_torch.kernels.serve_round import kernel as K, ops, ref
    from repro_torch.studies import (link_explorer, link_layer,
                                     link_reliability)

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
    # (one nvcc process per source, all started together)
    t0 = time.perf_counter()
    sources = [K._SOURCE, LK._SOURCE, FK._SOURCE]
    _build.build_all(sources)
    for mod in (K, LK, FK):
        mod._lib()
    emit(phase="build", sources=[str(x.relative_to(ROOT)) for x in sources],
         seconds=time.perf_counter() - t0)

    # phase 2: each kernel against its plain version, and its time
    worst, timings = phase_kernel_vs_plain(torch, K, ref)
    worst_depart, depart_timings = phase_depart_vs_plain(torch, LK, LR)
    worst_flit, flit_timings = phase_flit_vs_plain(
        np, torch, FK, FR, MAX_PAYLOAD_B, P.link_layer.MAX_REPLAY_PPM)

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

    # phase 5: the link-layer studies at the reference's full sizes, with
    # the serve-scan count read around them
    K.LAUNCHES["serve_scan"] = 0
    logs = {}
    for name, module in (("link_layer", link_layer),
                         ("link_reliability", link_reliability)):
        rows, logs[name] = run_study(np, torch, P, K, module, name)
        derived = ";".join(r.derived for r in rows)
        # link_reliability asserts its three gates itself
        check("pass=False" not in derived and "=False" not in derived,
              f"{name}: an acceptance gate failed: {derived}")
    study_launches = K.LAUNCHES["serve_scan"]
    check(study_launches > 0, "the studies never launched serve_scan")
    launches += study_launches
    # each stacked sweep against its members run one by one (after the
    # count is read: these are timing runs)
    for name, log in logs.items():
        for run in log.runs:
            if run.stacked:
                emit(phase="stacked_vs_loop", study=name, sweep=run.label,
                     **stacked_vs_loop(torch, P, run))

    # phase 6: depart_times on real converged rounds (its path), against
    # the serve-scan kernel's departures
    cases = [(n, wl.hops, wl.channels, sched) for n, wl, sched in runs
             if n != "markers"]
    for study, label in (("link_layer", "ber_sweep"),
                         ("link_reliability", "tail/expected")):
        (run,) = [r for r in logs[study].runs if r.label == label]
        cases += [(f"{label}[{i}]", P.member(run.hops, i),
                   P.member(run.channels, i), P.member(run.schedule, i))
                  for i in range(len(run.schedule.rounds))]
    LK.LAUNCHES["segmented_depart"] = 0
    for name, hops, channels, sched in cases:
        n_items, err = depart_on_round(torch, P, LO, name, hops, channels,
                                       sched)
        emit(phase="depart_on_round", workload=name, serving_items=n_items,
             max_abs_err=err)
    depart_launches = LK.LAUNCHES["segmented_depart"]
    check(depart_launches == len(cases),
          f"{depart_launches} segmented_depart launches for {len(cases)} "
          f"rounds")

    # phase 7: the link explorer's flit-efficiency grid (flit_pack's path)
    FK.LAUNCHES["flit_pack"] = 0
    grid = link_explorer.kernel_grid(device="cuda")
    flit_launches = FK.LAUNCHES["flit_pack"]
    check(flit_launches > 0, "the kernel grid never launched flit_pack")
    cpu_grid = link_explorer.kernel_grid(device="cpu")
    check(np.allclose(grid, cpu_grid, rtol=1e-6, atol=0)
          and bool((np.diff(grid, axis=1) <= 0).all()),
          f"flit grid: card {grid.tolist()} vs CPU {cpu_grid.tolist()}")
    emit(phase="link_explorer", grid=grid.tolist(),
         max_abs_diff_vs_cpu=float(np.abs(grid - cpu_grid).max()))

    main_k = 268_800
    t = timings[main_k]
    td = depart_timings[main_k]
    tf = flit_timings[1 << 24]
    emit(kernels=[
        dict(name="serve_scan", route="cuda",
             source="src/repro_torch/kernels/serve_round/csrc/serve_round.cu",
             replaces="src/repro/kernels/serve_round/kernel.py:104",
             launches=launches, max_abs_err=worst, ms=t["ms"],
             plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
             bound_by=t["bound_by"], library_ms=None, K=main_k),
        dict(name="segmented_depart", route="cuda",
             source="src/repro_torch/kernels/link_contention/csrc/"
                    "link_contention.cu",
             replaces="src/repro/kernels/link_contention/kernel.py:94",
             launches=depart_launches, max_abs_err=worst_depart,
             ms=td["ms"], plain_ms=td["plain_ms"], bound_ms=td["bound_ms"],
             bound_by=td["bound_by"], library_ms=None, K=main_k),
        dict(name="flit_pack", route="cuda",
             source="src/repro_torch/kernels/flit_pack/csrc/flit_pack.cu",
             replaces="src/repro/kernels/flit_pack/kernel.py:59",
             launches=flit_launches, max_abs_err=worst_flit, ms=tf["ms"],
             plain_ms=tf["plain_ms"], bound_ms=tf["bound_ms"],
             bound_by=tf["bound_by"], library_ms=None, K=1 << 24)])

    leaked = sorted(m for m in sys.modules if m in ("jax", "repro")
                    or m.startswith(("jax.", "jaxlib", "repro.")))
    check(not leaked, f"imported JAX or the reference package: {leaked}")
    emit(ok=True, device=dict(platform="gpu", kind=kind,
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
