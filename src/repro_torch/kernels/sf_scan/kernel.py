"""Snoop-filter protocol scan — the Hopper CUDA kernel's wrapper.

No Pallas kernel computes this function: the reference runs
``repro/core/snoop_filter.py::simulate_sf`` (line 210) as one ``lax.scan``,
which XLA compiles into one device loop.  Step for step in PyTorch that
is a few dozen launches and host reads a request (`ref.scan_one`); this
kernel runs the whole stream in one launch.  It is CUDA C++ for ``sm_90a``
in ``csrc/sf_scan.cu``, built with ``nvcc`` at first use (`kernels._build`)
and called through ``ctypes`` on PyTorch's current stream.

One warp (a block of 32 threads) owns one request stream (a job), so no
carry crosses blocks; several jobs (the members of a policy or InvBlk
sweep) run in one launch, one block each, their configuration read from a
table.  A step reads what the previous one wrote, so the bound on the H100
is the chain of dependent accesses of a step, not bytes or operations (see
the source's note; the function's bytes are the stream in and the
per-request outputs out).  The design cuts each step to the work its case
needs: line-indexed maps of the SF and of each cache row make every lookup
one read, running counts and two-level bitmaps replace the recounts, an
order list gives the fifo, lifo, lru and mru victim, lane 0 runs the
steps, and the 32 lanes join only for an lfi or blp victim search or a
least-recent slot (a miss on a full cache row).  The state, maps, bitmaps
and links sit in shared memory when they fit (the paper's size, SF and
caches of 819 lines over 4,096, takes about 90 KB: `smem_bytes`);
otherwise the state stays in device memory and the rest goes to a
workspace allocated here (`work_words`).  The maps rest on unique valid
tags in the SF and in each cache row; `ref.check_states` raises on a state
that breaks that, before the launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import load_library
from .ref import OUT_DTYPES, ScanJob, check_config, check_states

_SOURCE = Path(__file__).resolve().parent / "csrc" / "sf_scan.cu"

# launches of the CUDA kernel, counted by the wrapper (a run resets it to 0
# and reads it back to show that its path went through the kernel)
LAUNCHES = {"sf_scan": 0}

# the kernel's per-job parameter table, one int64 each, in this order (the
# source's `Param` enum; `sf_scan_param_count` checks the length)
PARAMS = (
    "T", "R", "CC", "CS", "F", "POLICY", "MAXLEN", "T_HIT", "T_CACHE",
    "T_SF", "MISS_PATH", "BISNP_RTT", "WRITEBACK", "PROBE", "TRANSFER",
    "ADDR", "WRITE", "RID", "FAB",
    "CACHE_TAG", "CACHE_SEQ", "SF_TAG", "SF_OWNER", "SF_DIRTY", "SF_INS",
    "SF_ACC", "LFI", "PRESENT", "CLOCK", "SCALARS",
    "LATENCY", "HIT", "OWNER0", "CACHED0", "FAB_ISSUE", "BISNP_MASK",
    "INV_LINES", "WB_LINES", "NEED_VICTIM", "CONFLICT", "INVBLK_LEN",
    "WORK")
_STATE_DTYPES = (torch.int32, torch.int64, torch.int32, torch.int32,
                 torch.bool, torch.int64, torch.int64, torch.int32,
                 torch.bool, torch.int64)


def _lib():
    lib = load_library(_SOURCE)
    if lib.sf_scan_launch.argtypes is None:
        lib.sf_scan_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
        lib.sf_scan_launch.restype = ctypes.c_int
        lib.sf_scan_param_count.argtypes = []
        lib.sf_scan_param_count.restype = ctypes.c_int
        lib.sf_scan_max_smem.argtypes = [ctypes.c_int]
        lib.sf_scan_max_smem.restype = ctypes.c_int
        if lib.sf_scan_param_count() != len(PARAMS):
            raise RuntimeError("sf_scan.cu's parameter table does not match "
                               "kernel.PARAMS")
    return lib


def work_words(cfg) -> int:
    """4-byte words of a job's maps, bitmaps and order links: the SF map
    (F), one map per cache row (R * F), the free-entry bitmap and each
    row's empty-slot bitmap (a word per 32 items, a word per 32 of those),
    and the order list's two links per SF entry."""
    r, cc, cs, f = (cfg.n_requesters, cfg.cache_capacity, cfg.sf_capacity,
                    cfg.footprint)
    nls, nlc = -(-cs // 32), -(-cc // 32)
    return (f + r * f + nls + -(-nls // 32) + r * (nlc + -(-nlc // 32))
            + 2 * cs)


def smem_bytes(cfg) -> int:
    """Shared memory one block needs to hold a job's state with its maps
    and bitmaps (the source's layout: 8-byte arrays, then 4-byte, then
    1-byte ones)."""
    r, cc, cs, f = (cfg.n_requesters, cfg.cache_capacity, cfg.sf_capacity,
                    cfg.footprint)
    b8 = 8 * (2 * cs + r * cc + r)
    b4 = 4 * (2 * cs + r * cc + f + work_words(cfg))
    return b8 + b4 + cs + f


def sf_scan_kernel(jobs: list[ScanJob]) -> list:
    """Scan every job in one launch (one block each) on the card; returns,
    per job, ``(outs, final_state)`` as `ref.sf_scan_ref` does (the same
    signature, so the two swap).  Raises on any tensor the kernel does not
    take, on a state the line-indexed maps cannot hold (`check_states`:
    one read back) or on a failed launch."""
    lib = _lib()
    dev = jobs[0].addr.device
    rows, results = [], []
    for job in jobs:
        cfg = job.cfg
        check_config(cfg)
        t = int(job.addr.shape[0])
        if t >= 1 << 31:
            raise ValueError(f"sf_scan takes streams of under 2**31 "
                             f"requests, not {t}")
        for x, dtype in ((job.addr, torch.int32), (job.is_write, torch.bool),
                         (job.rid, torch.int32)):
            if not (x.is_cuda and x.device == dev and x.dtype == dtype
                    and x.is_contiguous() and x.shape == (t,)):
                raise ValueError("sf_scan takes contiguous (T,) CUDA tensors: "
                                 "int32 addr, bool is_write, int32 rid")
        if job.fab is not None and not (
                job.fab.is_cuda and job.fab.device == dev
                and job.fab.dtype == torch.int64
                and job.fab.is_contiguous() and job.fab.shape == (t,)):
            raise ValueError("sf_scan takes fab as a contiguous (T,) int64 "
                             "CUDA tensor")
        shapes = ((cfg.n_requesters, cfg.cache_capacity),) * 2 + (
            (cfg.sf_capacity,),) * 5 + ((cfg.footprint,),) * 2 + (
            (cfg.n_requesters,),)
        state = []
        for x, dtype, shape in zip(job.state[:10], _STATE_DTYPES, shapes):
            if x.dtype != dtype or tuple(x.shape) != shape:
                raise ValueError(f"sf_scan state: {dtype} {shape} expected, "
                                 f"got {x.dtype} {tuple(x.shape)}")
            # the kernel writes the final state into these copies
            state.append(x.to(dev, copy=True).contiguous())
        scalars = torch.stack([x.to(dev, torch.int64).reshape(())
                               for x in job.state[10:]])
        outs = {f: torch.empty(t, dtype=d, device=dev)
                for f, d in OUT_DTYPES.items()
                if job.events or f in ("latency", "cache_hit", "owner_lines",
                                       "cached_lines")}

        def ptr(x):
            return 0 if x is None else x.data_ptr()

        rows.append([
            t, cfg.n_requesters, cfg.cache_capacity, cfg.sf_capacity,
            cfg.footprint, cfg.policy, cfg.maxlen, cfg.t_hit_ps,
            cfg.t_cache_ps, cfg.t_sf_ps, cfg.miss_path_ps, cfg.bisnp_rtt_ps,
            cfg.writeback_ps, cfg.probe_conflict_ps, cfg.transfer_ps,
            ptr(job.addr), ptr(job.is_write), ptr(job.rid), ptr(job.fab),
            *(ptr(x) for x in state), ptr(scalars),
            *(ptr(outs.get(f)) for f in (
                "latency", "cache_hit", "owner_lines", "cached_lines",
                "fab_issue", "bisnp_mask", "inv_lines", "wb_lines",
                "need_victim", "conflict", "invblk_len")), 0])
        results.append((outs, state, scalars))
    check_states(jobs)
    need = max(smem_bytes(job.cfg) for job in jobs)
    with torch.cuda.device(dev):
        smem = need if need <= lib.sf_scan_max_smem(dev.index or 0) else 0
        # a job whose state stays in device memory keeps its maps and
        # bitmaps in a workspace (the kernel builds them in its preamble)
        work = []
        for row, job in zip(rows, jobs):
            if smem_bytes(job.cfg) > smem:
                work.append(torch.empty(work_words(job.cfg),
                                        dtype=torch.int32, device=dev))
                row[-1] = work[-1].data_ptr()
        table = torch.tensor(rows, dtype=torch.int64).to(dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sf_scan_launch(table.data_ptr(), len(jobs), smem, stream)
    if err != 0:
        raise RuntimeError(f"sf_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["sf_scan"] += 1
    return [(outs, (*state, *scalars.unbind()))
            for outs, state, scalars in results]
