"""Device coherency agent (DCOH): device-side inclusive snoop filter, PyTorch
port.

The counterpart of ``repro.core.snoop_filter`` (ESF §III-D, §V-B, §V-C):
an *inclusive* snoop filter recording every line of the device's HDM that a
requester caches, with owners and state per entry; a conflict or capacity
victim sends Back-Invalidate Snoops (BISnp) to the owners, and InvBlk
clears up to ``invblk_max`` address-contiguous entries at once.  Victim
policies: FIFO, LRU, LFI, LIFO, MRU and block-length-prioritized (blp).

The protocol is sequential.  The reference runs it as one ``lax.scan``,
which XLA compiles into one device loop; here it runs through
`kernels.sf_scan`: a hand-written CUDA kernel (one warp walks one request
stream, its state and line-indexed maps in shared memory) when the tensors
lie on the card, the plain PyTorch step loop when they lie on the CPU.  Both are
bit-equal to the reference: every quantity is an integer.

Fabric coupling hooks (`core.coherence_traffic`), as in the reference:
``return_events=True`` adds the per-request `SFEvents` log, and
``fabric_lat_ps`` replaces the analytic miss path with measured latencies.
``init_state`` / ``return_state`` carry the protocol state between chunks
of a stream; chunked runs equal the monolithic run bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.sf_scan.ops import sf_scan
from ..kernels.sf_scan.ref import POLICY_CODES, STATE_FIELDS, ScanConfig, \
    ScanJob
from .engine import resolve_device, to_device

POLICIES = ("fifo", "lru", "lfi", "lifo", "mru", "blp")


@dataclass(frozen=True)
class SFConfig:
    capacity: int
    policy: str = "fifo"
    invblk_max: int = 1            # 1 = plain BISnp; 2..4 = InvBlk lengths
    footprint_lines: int = 4096
    # timing (picoseconds)
    t_cache_ps: int = 12_000       # Table III cache access
    t_sf_ps: int = 12_000          # SF lookup/update
    miss_path_ps: int = 122_000    # link RTT + controller + DRAM on a miss
    bisnp_rtt_ps: int = 64_000     # BISnp/BIRsp round trip
    writeback_ps: int = 15_000     # dirty flush to endpoint
    probe_conflict_ps: int = 6_000  # per extra InvBlk line beyond the first
    # pair (owner cache probes and BIRsp collection serialize, §V-C)
    line_bytes: int = 64
    bus_MBps: int = 0              # 0 = infinite bus (paper §V-B isolation)


@dataclass(frozen=True)
class CacheConfig:
    capacity: int
    t_cache_ps: int = 12_000


class SFEvents(NamedTuple):
    """Dense per-request protocol-decision log (fabric lowering contract).

    Decisions depend only on the order of the requests, never on
    latencies, so the log is the same whether latencies come from the
    analytic constants or from a fabric measurement.  ``fab_issue_ps`` is
    recorded for every request, hits included: the requester's clock after
    its local cache access."""

    fab_issue_ps: torch.Tensor   # (T,) int64 per-request issue clock
    cache_hit: torch.Tensor      # (T,) bool — hits never reach the fabric
    bisnp_mask: torch.Tensor     # (T,) int32 bitmask of snooped requesters
    inv_lines: torch.Tensor      # (T,) int32 lines invalidated
    wb_lines: torch.Tensor       # (T,) int32 dirty lines flushed
    need_victim: torch.Tensor    # (T,) bool capacity victim selected
    conflict: torch.Tensor       # (T,) bool write-conflict BISnp
    invblk_len: torch.Tensor     # (T,) int32 InvBlk run length (0 if none)


class SFState(NamedTuple):
    """Per-step protocol state of the scan, carried between chunks of a
    stream (`sf_init_state` / ``init_state=`` / ``return_state=True``)."""

    cache_tag: torch.Tensor   # (R, Cc) int32, -1 empty
    cache_seq: torch.Tensor   # (R, Cc) int64 LRU stamps
    sf_tag: torch.Tensor      # (Cs,) int32, -1 empty
    sf_owner: torch.Tensor    # (Cs,) int32 bitmask
    sf_dirty: torch.Tensor    # (Cs,) bool
    sf_ins: torch.Tensor      # (Cs,) int64 insertion stamps
    sf_acc: torch.Tensor      # (Cs,) int64 access stamps
    lfi_count: torch.Tensor   # (F,) int32 per-address insert counts
    present: torch.Tensor     # (F,) bool SF presence bitmap
    clock: torch.Tensor       # (R,) int64 per-requester time
    bus_free: torch.Tensor    # () int64
    seq: torch.Tensor         # () int64
    bisnp: torch.Tensor       # () int64
    inval: torch.Tensor       # () int64


assert SFState._fields == STATE_FIELDS


def sf_init_state(sf_cfg: SFConfig, cache_cfg: CacheConfig,
                  n_requesters: int = 1, device="cuda") -> SFState:
    """Cold protocol state (what `simulate_sf` starts from by default)."""
    dev = resolve_device(device)
    R, Cc, Cs = n_requesters, cache_cfg.capacity, sf_cfg.capacity
    F = sf_cfg.footprint_lines

    def full(shape, val, dtype):
        return torch.full(shape, val, dtype=dtype, device=dev)

    return SFState(
        cache_tag=full((R, Cc), -1, torch.int32),
        cache_seq=full((R, Cc), 0, torch.int64),
        sf_tag=full((Cs,), -1, torch.int32),
        sf_owner=full((Cs,), 0, torch.int32),
        sf_dirty=full((Cs,), False, torch.bool),
        sf_ins=full((Cs,), 0, torch.int64),
        sf_acc=full((Cs,), 0, torch.int64),
        lfi_count=full((F,), 0, torch.int32),
        present=full((F,), False, torch.bool),
        clock=full((R,), 0, torch.int64),
        bus_free=full((), 0, torch.int64),
        seq=full((), 1, torch.int64),
        bisnp=full((), 0, torch.int64),
        inval=full((), 0, torch.int64),
    )


class SFResult(NamedTuple):
    latency_ps: torch.Tensor       # (T,) per-request latency
    cache_hit: torch.Tensor        # (T,) bool
    bisnp_events: torch.Tensor     # () total BISnp requests sent
    invalidated_lines: torch.Tensor  # () total lines invalidated
    total_time_ps: torch.Tensor    # () max requester clock
    bandwidth_MBps: torch.Tensor   # () delivered line bytes / total time
    owner_lines: torch.Tensor      # (T,) lines owned in SF by requester 0
    cached_lines: torch.Tensor     # (T,) lines present in requester 0 cache
    final_sf_tag: torch.Tensor     # (Cs,)
    final_sf_owner: torch.Tensor   # (Cs,)
    final_cache_tag: torch.Tensor  # (R, Cc)


def owner_count(mask) -> torch.Tensor:
    """Popcount of requester bitmasks (`SFEvents.bisnp_mask`): the BISnp
    fan-out of each request.  The reference's branch-free SWAR on uint32,
    taken in int64 with the value and the product masked to 32 bits (torch's
    uint32 has few operations); int32 result, equal for every mask."""
    v = torch.as_tensor(mask).long() & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).int()


def scan_config(sf_cfg: SFConfig, cache_cfg: CacheConfig,
                n_requesters: int) -> ScanConfig:
    """The integers the scan kernel takes for one configuration."""
    if sf_cfg.policy not in POLICY_CODES:
        raise ValueError(f"unknown policy {sf_cfg.policy!r}")
    transfer_ps = (
        0 if sf_cfg.bus_MBps == 0
        else (sf_cfg.line_bytes * 1_000_000_000_000)
        // (sf_cfg.bus_MBps * 1_000_000))
    return ScanConfig(
        policy=POLICY_CODES[sf_cfg.policy],
        maxlen=max(int(sf_cfg.invblk_max), 1),
        n_requesters=int(n_requesters),
        cache_capacity=int(cache_cfg.capacity),
        sf_capacity=int(sf_cfg.capacity),
        footprint=int(sf_cfg.footprint_lines),
        t_hit_ps=int(cache_cfg.t_cache_ps),
        t_cache_ps=int(sf_cfg.t_cache_ps),
        t_sf_ps=int(sf_cfg.t_sf_ps),
        miss_path_ps=int(sf_cfg.miss_path_ps),
        bisnp_rtt_ps=int(sf_cfg.bisnp_rtt_ps),
        writeback_ps=int(sf_cfg.writeback_ps),
        probe_conflict_ps=int(sf_cfg.probe_conflict_ps),
        transfer_ps=int(transfer_ps))


def _stream(x, dtype, dev):
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return x.to(device=dev, dtype=dtype).contiguous()


def simulate_sf_many(runs: list[dict]) -> list:
    """Run several `simulate_sf` calls at once: ``runs`` holds the keyword
    arguments of each (``addr``, ``is_write``, ``req_id``, ``sf_cfg``,
    ``cache_cfg`` and the optional ones), all on one device; returns what
    each call would return, in order.  On the card the streams scan in one
    kernel launch, one thread block each (a policy or InvBlk sweep)."""
    jobs = [scan_job(**kw) for kw in runs]
    return [_result(job, kw, outs, final)
            for job, kw, (outs, final) in zip(jobs, runs, sf_scan(jobs))]


def scan_job(addr, is_write, req_id, sf_cfg: SFConfig,
             cache_cfg: CacheConfig, n_requesters: int = 1,
             fabric_lat_ps=None, return_events: bool = False,
             init_state: SFState | None = None, return_state: bool = False,
             device=None) -> ScanJob:
    """The `kernels.sf_scan` job of one `simulate_sf` call (its arguments,
    checked and moved to the device)."""
    if device is None:
        device = addr.device if isinstance(addr, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    cfg = scan_config(sf_cfg, cache_cfg, n_requesters)
    a = _stream(addr, torch.int32, dev)
    w = _stream(is_write, torch.bool, dev)
    r = _stream(req_id, torch.int32, dev)
    if not a.shape == w.shape == r.shape or a.dim() != 1:
        raise ValueError("addr, is_write and req_id must be (T,) alike")
    if a.numel():
        a_lo, a_hi, r_lo, r_hi = torch.stack(
            [a.min(), a.max(), r.min(), r.max()]).tolist()
        if a_lo < 0 or a_hi >= cfg.footprint:
            raise ValueError(f"addresses outside [0, {cfg.footprint})")
        if r_lo < 0 or r_hi >= cfg.n_requesters:
            raise ValueError(f"requester ids outside [0, {cfg.n_requesters})")
    fab = (None if fabric_lat_ps is None
           else _stream(fabric_lat_ps, torch.int64, dev))
    if fab is not None and fab.shape != a.shape:
        raise ValueError("fabric_lat_ps must be (T,) like addr")
    state = (sf_init_state(sf_cfg, cache_cfg, n_requesters, dev)
             if init_state is None
             else SFState(*(to_device(x, dev) for x in init_state)))
    return ScanJob(a, w, r, tuple(state), cfg, fab, bool(return_events))


def _result(job: ScanJob, kw: dict, outs: dict, final):
    final = SFState(*final)
    n = int(job.addr.shape[0])
    line = kw["sf_cfg"].line_bytes
    total = final.clock.max()
    # int64 as the reference computes it (it wraps past ~144k requests of
    # 64-byte lines)
    bw = (torch.tensor(n * line, dtype=torch.int64, device=total.device)
          * 1_000_000_000_000 // torch.clamp_min(total, 1) // 1_000_000)
    res = SFResult(
        latency_ps=outs["latency"], cache_hit=outs["cache_hit"],
        bisnp_events=final.bisnp, invalidated_lines=final.inval,
        total_time_ps=total, bandwidth_MBps=bw,
        owner_lines=outs["owner_lines"], cached_lines=outs["cached_lines"],
        final_sf_tag=final.sf_tag, final_sf_owner=final.sf_owner,
        final_cache_tag=final.cache_tag)
    out = (res,)
    if kw.get("return_events", False):
        out += (SFEvents(
            fab_issue_ps=outs["fab_issue"], cache_hit=outs["cache_hit"],
            bisnp_mask=outs["bisnp_mask"], inv_lines=outs["inv_lines"],
            wb_lines=outs["wb_lines"], need_victim=outs["need_victim"],
            conflict=outs["conflict"], invblk_len=outs["invblk_len"]),)
    if kw.get("return_state", False):
        out += (final,)
    return out if len(out) > 1 else res


def simulate_sf(addr, is_write, req_id, sf_cfg: SFConfig,
                cache_cfg: CacheConfig, n_requesters: int = 1,
                fabric_lat_ps=None, return_events: bool = False,
                init_state: SFState | None = None,
                return_state: bool = False, device=None):
    """Run the DCOH protocol over a merged request stream.

    addr      (T,) int32 line addresses in [0, footprint)
    is_write  (T,) bool
    req_id    (T,) int32 in [0, n_requesters)

    Runs on ``device`` (by default the device of ``addr`` when it is a
    tensor, else the card).  ``fabric_lat_ps`` ((T,) int64) replaces the
    analytic miss path with fabric-measured latencies;
    ``return_events=True`` returns ``(SFResult, SFEvents)``;
    ``init_state`` resumes a stream mid-way and ``return_state=True``
    appends the final `SFState`.  Carried clocks and counters are
    cumulative, so a chunk's ``total_time_ps`` / ``bisnp_events`` are
    absolute, and ``bandwidth_MBps`` divides only this chunk's bytes, as in
    the reference."""
    return simulate_sf_many([dict(
        addr=addr, is_write=is_write, req_id=req_id, sf_cfg=sf_cfg,
        cache_cfg=cache_cfg, n_requesters=n_requesters,
        fabric_lat_ps=fabric_lat_ps, return_events=return_events,
        init_state=init_state, return_state=return_state, device=device)])[0]


def make_skewed_stream(n: int, footprint: int, hot_frac: float = 0.1,
                       hot_ratio: float = 0.9, write_ratio: float = 0.0,
                       n_requesters: int = 1, seed: int = 0, device="cuda"):
    """Paper §V-B request pattern: 90% of accesses to the hot 10% of lines.
    The reference's numpy draws; ``(addr, is_write, req_id)`` on
    ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    hot_n = max(int(footprint * hot_frac), 1)
    is_hot = rng.random(n) < hot_ratio
    addr = np.where(is_hot, rng.integers(0, hot_n, n),
                    hot_n + rng.integers(0, footprint - hot_n, n)).astype(np.int32)
    wr = rng.random(n) < write_ratio
    rid = (np.arange(n) % n_requesters).astype(np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (addr, wr, rid))


def make_sequential_stream(n: int, footprint: int, n_requesters: int = 2,
                           write_ratio: float = 0.0, seed: int = 0,
                           device="cuda"):
    """Paper §V-C pattern: requesters issue sequential (streaming)
    addresses.  The reference's numpy draws; tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    per = n // n_requesters
    addr = np.concatenate(
        [np.arange(per, dtype=np.int32) % footprint
         for _ in range(n_requesters)])
    rid = np.concatenate(
        [np.full(per, r, np.int32) for r in range(n_requesters)])
    order = np.arange(per * n_requesters).reshape(n_requesters, per).T.reshape(-1)
    wr = rng.random(per * n_requesters) < write_ratio
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (addr[order], wr, rid[order]))
