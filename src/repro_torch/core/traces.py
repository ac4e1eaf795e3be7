"""Real-world workload traces (ESF trace-based mode, paper §V-E).

The paper replays one-million-access memory traces of five representative
workloads (BTree, liblinear, redis, silo, XSBench) collected with the tool of
MQSim_CXL [61].  Those binary traces are not redistributable here, so this
module provides:

  * generators that synthesize traces with the published access-pattern
    statistics of each workload (read/write **mix degree** = min(read ratio,
    write ratio) — the x-axis of Fig. 20a —, spatial locality, working-set
    shape), clearly labeled as synthetic stand-ins; and
  * a loader for the MQSim_CXL-style CSV schema (``cycle,address,is_write``)
    so genuine traces drop in unchanged.

Mix degrees below follow the ordering visible in Fig. 20a (BTree and XSBench
read-dominated; silo the most mixed).

The PyTorch port's copy of ``repro.core.traces``: the generators stay numpy,
seeded through ``zlib.crc32``, so every array equals the reference's; only
`request_stream` hands its arrays over as torch tensors on a device.  The
zipf ranks come from `_zipf`, a transcription of numpy 2.0.2's
``Generator.zipf`` on the generator's own doubles, so they do not depend on
the numpy build of the host that runs the port.
"""

from __future__ import annotations

import math
import zlib

import numpy as np

from .engine import resolve_device, to_device

# name -> (write_ratio, pattern, locality notes)
WORKLOADS = {
    # write_ratio, pattern
    "xsbench":   (0.02, "random"),    # MC neutronics: huge read-only lookups
    "btree":     (0.08, "pointer"),   # index probes, occasional inserts
    "liblinear": (0.18, "scan"),      # feature-matrix scans + model updates
    "redis":     (0.30, "zipf"),      # YCSB-style mixed GET/SET
    "silo":      (0.45, "oltp"),      # in-memory OLTP, read-modify-write
}


# int64 max as a double (2**63), the bound numpy's C loop compares against
_INT64_MAX_F = float(np.iinfo(np.int64).max)


def _zipf(rng: np.random.Generator, a: float, n: int) -> np.ndarray:
    """``rng.zipf(a, n)`` as numpy 2.0.2 draws it, on any numpy build.

    numpy's zipf is its own rejection loop over the bit generator's doubles,
    and numpy versions differ in that loop (newer sources cut ``U`` below),
    so the same seed gives other ranks elsewhere; everything drawn after the
    ranks shifts with them.  This is numpy 2.0.2's loop, one pair of
    ``rng.random()`` doubles per try, with the C library's ``pow``
    (`math.pow`; numpy's vectorised ``power`` may round its last bit
    differently).  The doubles are drawn in blocks from a copy of the
    generator; the generator itself then advances by exactly the pairs the
    loop used, so the draws after it equal the reference's too."""
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    inv = -1.0 / am1
    bits = type(rng.bit_generator)()
    bits.state = rng.bit_generator.state
    probe = np.random.Generator(bits)
    out, pairs = [], 0
    while len(out) < n:
        d = probe.random(2 * (n - len(out))).tolist()
        for u01, v in zip(d[::2], d[1::2]):
            pairs += 1
            try:
                x = float(math.floor(math.pow(1.0 - u01, inv)))
            except OverflowError:  # C's pow gives inf there: rejected
                continue
            if x > _INT64_MAX_F or x < 1.0:
                continue
            t = math.pow(1.0 + 1.0 / x, am1)
            if v * x * (t - 1.0) / (b - 1.0) <= t / b:
                # C's cast of 2**63 to int64 gives int64 min on x86
                out.append(int(x) if x < _INT64_MAX_F else -(1 << 63))
                if len(out) == n:
                    break
    rng.random(2 * pairs)
    return np.array(out, dtype=np.int64)


def mix_degree(is_write: np.ndarray) -> float:
    w = float(np.mean(is_write))
    return min(w, 1.0 - w)


def generate(name: str, n: int = 100_000, footprint_lines: int = 1 << 16,
             seed: int = 0) -> dict:
    """Synthesize a trace with the workload's characteristic statistics."""
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; have {sorted(WORKLOADS)}")
    write_ratio, pattern = WORKLOADS[name]
    # stable per-workload stream: zlib.crc32 is process-independent, unlike
    # hash() under PYTHONHASHSEED randomization — traces must reproduce
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 65536)

    if pattern == "random":
        addr = rng.integers(0, footprint_lines, n)
    elif pattern == "pointer":
        # random walk through a tree: bursts of depth ~4 with random restarts
        restarts = rng.integers(0, footprint_lines, n)
        addr = restarts.copy()
        depth = rng.integers(0, 4, n)
        addr = (addr // (1 << depth) + depth) % footprint_lines
    elif pattern == "scan":
        # long sequential scans with occasional jumps
        jump = rng.random(n) < 0.01
        steps = np.where(jump, rng.integers(0, footprint_lines, n), 1)
        addr = np.cumsum(steps) % footprint_lines
    elif pattern == "zipf":
        ranks = _zipf(rng, 1.2, n)
        addr = (ranks * 2654435761) % footprint_lines
    elif pattern == "oltp":
        # hot rows + uniform tail; read-modify-write pairs
        hot = rng.random(n) < 0.6
        addr = np.where(hot, rng.integers(0, footprint_lines // 16, n),
                        rng.integers(0, footprint_lines, n))
    else:  # pragma: no cover
        raise AssertionError(pattern)

    is_write = rng.random(n) < write_ratio
    if pattern == "oltp":
        # RMW: a write tends to follow a read of the same line
        is_write[1:] &= True
        addr[1:] = np.where(is_write[1:], addr[:-1], addr[1:])
    return {
        "name": name,
        "addr": addr.astype(np.int64),
        "is_write": is_write.astype(bool),
        "mix_degree": mix_degree(is_write),
        "synthetic": True,
    }


ARRIVAL_PATTERNS = ("uniform", "poisson", "bursty", "periodic")


def arrival_times(n: int, mean_gap_ps: int = 2000,
                  pattern: str = "uniform", seed: int = 0,
                  burst_len: int = 64, duty: float = 0.25,
                  period: int = 4096) -> np.ndarray:
    """Issue times (ps, non-decreasing, first at 0) for an ``n``-request
    open-loop stream at a target mean inter-arrival gap.

      uniform    constant gap (the seed benches' implicit timing);
      poisson    exponential gaps — memoryless datacenter arrivals;
      bursty     ON-OFF: bursts of ``burst_len`` requests at ``duty`` of the
                 mean gap, separated by pauses that restore the mean rate —
                 the tail-stressing shape (queue builds inside every burst);
      periodic   sinusoid-modulated gap (±60 % over ``period`` requests) —
                 diurnal-style load swings.

    De-randomized like `generate`: crc32 of the pattern name folds into the
    seed, so streams reproduce across processes.
    """
    if pattern not in ARRIVAL_PATTERNS:
        raise KeyError(f"unknown arrival pattern {pattern!r}; "
                       f"have {ARRIVAL_PATTERNS}")
    rng = np.random.default_rng(
        seed + zlib.crc32(("arr:" + pattern).encode()) % 65536)
    if pattern == "uniform":
        gaps = np.full(n, mean_gap_ps, np.int64)
    elif pattern == "poisson":
        gaps = rng.exponential(mean_gap_ps, n).astype(np.int64)
    elif pattern == "bursty":
        on_gap = max(int(mean_gap_ps * duty), 1)
        pause = burst_len * mean_gap_ps - (burst_len - 1) * on_gap
        gaps = np.where(np.arange(n) % burst_len == 0,
                        np.int64(max(pause, 0)), np.int64(on_gap))
    else:  # periodic
        phase = 2.0 * np.pi * (np.arange(n) % period) / period
        gaps = (mean_gap_ps * (1.0 + 0.6 * np.sin(phase))).astype(np.int64)
    gaps = np.maximum(gaps, 0)
    if n:
        gaps[0] = 0
    return np.cumsum(gaps).astype(np.int64)


def tenant_mix(tenants, n: int = 10_000, footprint_lines: int = 4096,
               seed: int = 0) -> dict:
    """Multi-tenant trace: each named workload runs in a private partition
    of the footprint and requests interleave round-robin — the noisy-
    neighbour shape (one tenant's bursts queue behind another's scans on the
    shared fabric).  ``tenant`` gives each request's tenant index; tenant
    substreams are crc32-de-randomized and decorrelated by tenant slot."""
    tenants = list(tenants)
    t = max(len(tenants), 1)
    share = max(footprint_lines // t, 1)
    tid = (np.arange(n) % t).astype(np.int32)
    addr = np.zeros(n, np.int64)
    is_write = np.zeros(n, bool)
    for i, name in enumerate(tenants):
        m = tid == i
        tr = generate(name, n=int(m.sum()), footprint_lines=share,
                      seed=seed + 7919 * i)
        addr[m] = (tr["addr"] % share) + i * share
        is_write[m] = tr["is_write"]
    return {
        "name": "mix:" + "+".join(tenants),
        "addr": addr,
        "is_write": is_write,
        "tenant": tid,
        "mix_degree": mix_degree(is_write),
        "synthetic": True,
    }


def _block(name: str, m: int, footprint_lines: int, seed: int):
    """One (addr, is_write, rid-or-None) block; ``mix:a+b`` names build a
    `tenant_mix` whose tenant index doubles as the requester id."""
    if name.startswith("mix:"):
        tr = tenant_mix(name[4:].split("+"), n=m,
                        footprint_lines=footprint_lines, seed=seed)
        return (tr["addr"] % footprint_lines).astype(np.int32), \
            tr["is_write"], tr["tenant"]
    tr = generate(name, n=m, footprint_lines=footprint_lines, seed=seed)
    return (tr["addr"] % footprint_lines).astype(np.int32), \
        tr["is_write"], None


def request_stream(name: str, n: int = 10_000, footprint_lines: int = 4096,
                   n_requesters: int = 1, seed: int = 0,
                   chunk: int | None = None, timing: str | None = None,
                   mean_gap_ps: int = 2000, device="cuda"):
    """Trace-driven request stream for the snoop-filter / coherence-fabric
    pipeline (paper §V-E trace mode driving the §V-B/§V-C machinery).

    Generates the named workload's synthetic trace, folds addresses into
    the DCOH footprint, and interleaves requesters round-robin — the same
    ``(addr, is_write, req_id)`` contract as
    `snoop_filter.make_skewed_stream`, so any bench accepting a stream
    source runs real-workload mixes unchanged.  Returns
    ``(addr, is_write, req_id)`` tensors on ``device`` (the card by default;
    ``device="cpu"`` keeps them on the host).

    Extensions (the streaming engine's front end):

      * ``name="mix:redis+silo"`` runs a `tenant_mix`; the tenant index
        becomes the requester id.
      * ``timing`` (an `ARRIVAL_PATTERNS` name) appends an ``issue_ps``
        array from `arrival_times` — a 4-tuple instead of 3.
      * ``chunk=m`` returns a **generator** of such tuples, ``m`` requests
        each, for `streaming.simulate_stream`-style consumption at flat
        memory.  Chunks are independent per-chunk substreams (block ``b``
        reseeds at ``seed + 1000003·b`` — chunked output is deterministic
        but intentionally *not* request-for-request equal to the monolithic
        trace); issue times chain across chunks so the stream stays
        time-ordered.
    """
    dev = resolve_device(device)
    if timing is None and chunk is not None:
        timing = "uniform"

    def emit(m, blk_seed, t0):
        addr, is_write, tenant = _block(name, m, footprint_lines, blk_seed)
        rid = (tenant if tenant is not None
               else (np.arange(m) % max(n_requesters, 1)).astype(np.int32))
        out = (to_device(addr, dev), to_device(is_write, dev),
               to_device(rid, dev))
        if timing is None:
            return out
        iss = t0 + arrival_times(m, mean_gap_ps=mean_gap_ps,
                                 pattern=timing, seed=blk_seed)
        return out + (to_device(iss, dev),)

    if chunk is None:
        return emit(n, seed, 0)

    def gen():
        t0 = 0
        b = 0
        left = n
        while left > 0:
            m = min(chunk, left)
            yield emit(m, seed + 1000003 * b, t0)
            t0 += m * mean_gap_ps
            b += 1
            left -= m

    return gen()


def load_csv(path: str) -> dict:
    """Load an MQSim_CXL-schema trace: lines of ``cycle,address,is_write``."""
    raw = np.loadtxt(path, delimiter=",", dtype=np.int64, ndmin=2)
    return {
        "name": path,
        "cycle": raw[:, 0],
        "addr": raw[:, 1] // 64,     # byte address -> line
        "is_write": raw[:, 2].astype(bool),
        "mix_degree": mix_degree(raw[:, 2].astype(bool)),
        "synthetic": False,
    }


def save_csv(path: str, trace: dict) -> None:
    n = len(trace["addr"])
    cyc = trace.get("cycle", np.arange(n, dtype=np.int64))
    np.savetxt(path, np.stack([cyc, trace["addr"] * 64,
                               trace["is_write"].astype(np.int64)], axis=1),
               fmt="%d", delimiter=",")
