"""Plain PyTorch version of the snoop-filter protocol scan.

The counterpart of the body of ``repro/core/snoop_filter.py::simulate_sf``
(its ``step``, run by ``lax.scan``): the DCOH protocol of an inclusive
snoop filter, one request at a time, in stream order.  Each step looks the
request up in its requester's local cache and in the SF, picks a capacity
victim by the policy's score, clears the victim's InvBlk run (and those
lines in the owners' caches), applies the write-conflict invalidation,
fills the cache slot and upserts the SF entry, and advances the
requester's clock by the analytic latency (or, with ``fab``, by the
fabric-measured miss latency).

The SF and cache arrays are tensors; the request, the clocks and the
counters are host integers, and each step reads back the few values it
branches on (a hit, the victim, the cleared entries), so a step does only
the work its case needs: a victim search only when the SF is full and
misses, an invalidation only when there is one.  What the reference
computes and then discards (a victim when none is needed, a scatter of
unchanged values) is left out; every output and the final state are the
reference's.  Everything is integer, and the order of the updates is the
reference's:

  * ties break to the lowest index, as ``jnp.argmin`` / ``jnp.argmax`` do
    (``torch.argmin`` / ``torch.argmax`` return the first extreme too;
    ``argmax`` does not take bool, so masks are cast to int32 first);
  * the policy scores are int64 (`_scores`); invalid entries would score
    2**60, but a victim is only sought when every entry is valid;
  * the conflict owner write goes through the *old* SF tags, the cache
    invalidation comes before the slot fill, the clock is written for the
    requester only, and ``bus_free`` does not move on a hit;
  * the ``present`` bitmap's InvBlk clear writes ``present[i] & ~live[j]``
    through indices clipped to ``F - 1``, one offset after another, so where
    clipped offsets repeat an index the last write wins (as XLA on the CPU
    applies the reference's duplicate scatter);
  * int32 quantities wrap as the reference's do (`_i32`).

The same function runs on the card, where it is the yardstick the CUDA
kernel (`kernel.sf_scan_kernel`) is held against bit for bit; both take a
list of `ScanJob`s.  It is slow there: a few dozen small launches and a
few host reads a step.

`sf_scan_indexed` is the CUDA kernel's algorithm in plain Python, for the
CPU tests: a line-indexed map of the SF (``line -> entry``) and one per
cache row (``line -> slot``), two-level bitmaps of the free SF entries and
of each row's empty slots (lowest index by ``ffs``), running counts of the
free entries and of requester 0's SF and cache lines, an order list of the
entries by stamp whose end is the fifo, lifo, lru or mru victim, and a
search (the lfi or blp victim, the least-recent slot of a full row) only on
the steps that need one, split into 32 lanes' partials combined as the
warp combines them.  The maps rest on two invariants that the
reference keeps: valid SF tags are unique, and so are a cache row's valid
tags; `check_states` (called by the kernel's wrapper and by
`sf_scan_indexed`) raises on a starting state that breaks them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

POLICY_CODES = {"fifo": 0, "lru": 1, "lfi": 2, "lifo": 3, "mru": 4, "blp": 5}
BIG = 1 << 40
SMALL = 1 << 36
# InvBlk runs clear at most this many lines (the port's bound on the
# configurations it takes); CXL's InvBlk has 1 to 4
MAX_INVBLK = 64
# requester ids are bits of an int32 owner mask
MAX_REQUESTERS = 31

STATE_FIELDS = ("cache_tag", "cache_seq", "sf_tag", "sf_owner", "sf_dirty",
                "sf_ins", "sf_acc", "lfi_count", "present", "clock",
                "bus_free", "seq", "bisnp", "inval")
OUT_FIELDS = ("latency", "cache_hit", "owner_lines", "cached_lines")
EVENT_FIELDS = ("fab_issue", "bisnp_mask", "inv_lines", "wb_lines",
                "need_victim", "conflict", "invblk_len")


class ScanConfig(NamedTuple):
    """What one scan needs of the SF and cache configurations (all ints)."""

    policy: int          # POLICY_CODES value
    maxlen: int          # max(invblk_max, 1)
    n_requesters: int    # R
    cache_capacity: int  # Cc
    sf_capacity: int     # Cs
    footprint: int       # F
    t_hit_ps: int        # the requester cache's access (CacheConfig)
    t_cache_ps: int      # per extra InvBlk line (SFConfig.t_cache_ps)
    t_sf_ps: int
    miss_path_ps: int
    bisnp_rtt_ps: int
    writeback_ps: int
    probe_conflict_ps: int
    transfer_ps: int     # bus time of one line, 0 = infinite bus


class ScanJob(NamedTuple):
    """One request stream to scan: its tensors, the state it starts from
    (`STATE_FIELDS` order), its configuration, the optional fabric
    latencies and whether to log the events."""

    addr: torch.Tensor       # (T,) int32
    is_write: torch.Tensor   # (T,) bool
    rid: torch.Tensor        # (T,) int32
    state: tuple
    cfg: ScanConfig
    fab: torch.Tensor | None = None   # (T,) int64
    events: bool = False


def check_config(cfg: ScanConfig):
    """Raise on a configuration the scan does not take."""
    if cfg.policy not in POLICY_CODES.values():
        raise ValueError(f"unknown policy code {cfg.policy}")
    if not 1 <= cfg.maxlen <= MAX_INVBLK:
        raise ValueError(f"InvBlk length {cfg.maxlen} outside 1..{MAX_INVBLK}")
    if not 1 <= cfg.n_requesters <= MAX_REQUESTERS:
        raise ValueError(f"{cfg.n_requesters} requesters outside "
                         f"1..{MAX_REQUESTERS} (an int32 owner mask)")
    if min(cfg.cache_capacity, cfg.sf_capacity, cfg.footprint) < 1:
        raise ValueError("cache, SF and footprint sizes must be >= 1")
    if not 0 <= cfg.transfer_ps < 1 << 31:
        # the reference multiplies it with int32 run lengths
        raise ValueError(f"bus transfer {cfg.transfer_ps} ps outside int32")


def _scores(policy: int, sf_tag, sf_ins, sf_acc, lfi_count, run):
    """Lower score = better victim (int64)."""
    if policy == POLICY_CODES["fifo"]:
        return sf_ins
    if policy == POLICY_CODES["lifo"]:
        return -sf_ins
    if policy == POLICY_CODES["lru"]:
        return sf_acc
    if policy == POLICY_CODES["mru"]:
        return -sf_acc
    if policy == POLICY_CODES["lfi"]:
        # least frequently inserted address, gathered through a clipped
        # tag; ties broken LIFO
        cnt = lfi_count[sf_tag.clamp(0, lfi_count.shape[0] - 1).long()]
        return cnt.long() * BIG + (SMALL - sf_ins)
    # blp: longest contiguous run, ties broken LIFO
    return -(run.long() * BIG + sf_ins)


def _i32(x: int) -> int:
    """``x`` wrapped to int32, as the reference's int32 arithmetic wraps."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


OUT_DTYPES = {"latency": torch.int64, "cache_hit": torch.bool,
              "owner_lines": torch.int64, "cached_lines": torch.int64,
              "fab_issue": torch.int64, "bisnp_mask": torch.int32,
              "inv_lines": torch.int32, "wb_lines": torch.int32,
              "need_victim": torch.bool, "conflict": torch.bool,
              "invblk_len": torch.int32}


def sf_scan_ref(jobs: list[ScanJob]) -> list:
    """Run the protocol over each job's request stream, one after another;
    per job, what `scan_one` returns."""
    return [scan_one(*job) for job in jobs]


def scan_one(addr, is_write, rid, state, cfg: ScanConfig, fab=None,
             events: bool = False):
    """Run the protocol over one request stream.

    addr (T,) int32, is_write (T,) bool, rid (T,) int32, fab (T,) int64 or
    None; ``state`` the 14 `STATE_FIELDS` tensors (the last four 0-d int64),
    left unchanged.  Returns ``(outs, final_state)``: ``outs`` a dict of the
    `OUT_FIELDS` (and, with ``events``, the `EVENT_FIELDS`) per request,
    ``final_state`` a tuple in `STATE_FIELDS` order.
    """
    check_config(cfg)
    dev = addr.device
    (cache_tag, cache_seq, sf_tag, sf_owner, sf_dirty, sf_ins, sf_acc,
     lfi_count, present) = (x.clone() for x in state[:9])
    clock = state[9].tolist()
    bus_free, seq, bisnp, inval = (int(x) for x in state[10:])
    maxlen, foot, n_req = cfg.maxlen, cfg.footprint, cfg.n_requesters
    offs = torch.arange(maxlen, dtype=torch.int32, device=dev)
    # rows other than r, for the conflict invalidation
    others_rows = [(torch.arange(n_req, device=dev) != r)[:, None]
                   for r in range(n_req)]
    req_bits = (1 << n_req) - 1
    A, W, Rq = addr.tolist(), is_write.tolist(), rid.tolist()
    F_lat = fab.tolist() if fab is not None else None
    fields = OUT_FIELDS + (EVENT_FIELDS if events else ())
    outs = {f: [] for f in fields}
    owner_lines = cached_lines = None

    for i in range(len(A)):
        a, w, r = A[i], W[i], Rq[i]
        t = clock[r]
        rbit = 1 << r

        # requester local cache; SF lookup, write conflict, capacity
        chit = bool((cache_tag[r] == a).any())
        t_hit = t + cfg.t_hit_ps
        t_bus_ready = max(t_hit, bus_free)
        sline = sf_tag == a
        hits = sline.nonzero().flatten().tolist()
        sf_hit = bool(hits)
        owners_a = _i32(sum(sf_owner[hits].tolist())) if sf_hit else 0
        others = owners_a & ~rbit
        conflict = sf_hit and w and others != 0
        need_victim = not sf_hit and bool((sf_tag >= 0).all())

        n_clear = n_dirty = v_len = vmask = 0
        if need_victim:
            # victim: the policy's first minimum over the (all valid)
            # entries; run lengths of consecutive present lines for blp
            if cfg.policy == POLICY_CODES["blp"]:
                run = torch.ones_like(sf_tag)
                for d in range(1, maxlen):
                    nxt = (sf_tag + d).clamp(0, foot - 1).long()
                    ok = (run == d) & present[nxt] & ((sf_tag + d) < foot)
                    run = run + ok.int()
            else:
                run = None
            scores = _scores(cfg.policy, sf_tag, sf_ins, sf_acc, lfi_count,
                             run)
            victim = int(torch.argmin(scores))
            v_tag = int(sf_tag[victim])
            if run is not None:
                v_len = min(int(run[victim]), maxlen)
            else:
                # the same chain, for the victim's entry alone
                nxt = present[(offs[1:] + v_tag).clamp(0, foot - 1)
                              .long()].tolist()
                v_len = 1
                for d in range(1, maxlen):
                    if v_len == d and nxt[d - 1] and v_tag + d < foot:
                        v_len += 1

            # lines the (Inv)Blk BISnp clears: v_tag .. v_tag + v_len - 1,
            # the entries holding them, and the lines some entry held
            in_blk = sf_tag[:, None] == (offs[:v_len] + v_tag)
            held = in_blk.any(dim=0).tolist()
            idx = in_blk.any(dim=1).nonzero().flatten()
            cleared_owner = sf_owner[idx].tolist()
            n_clear = len(cleared_owner)
            n_dirty = int(sf_dirty[idx].sum())
            for o in cleared_owner:
                vmask |= o
            vmask &= req_bits
            sf_tag[idx] = -1
            sf_owner[idx] = 0
            sf_dirty[idx] = False
            sf_ins[idx] = 0
            sf_acc[idx] = 0
            # BISnp invalidates those lines in the owners' caches (the
            # cleared tags are >= 0, so no empty slot matches)
            inval_mask = None
            for d, h in enumerate(held):
                if h:
                    m = cache_tag == v_tag + d
                    inval_mask = m if inval_mask is None else inval_mask | m
            if inval_mask is not None:
                cache_tag.masked_fill_(inval_mask, -1)
                cache_seq.masked_fill_(inval_mask, 0)
            # presence bitmap: every old value first, then offset after
            # offset through indices clipped to F - 1, so a clipped index
            # that repeats keeps the last offset's value
            blk_idx = [min(max(v_tag + j, 0), foot - 1)
                       for j in range(maxlen)]
            old = present[blk_idx].tolist()
            last = {}
            for j, k in enumerate(blk_idx):
                last[k] = old[j] and not j < v_len
            for k, v in last.items():
                present[k] = v
        if conflict:
            # the conflict BISnp invalidates line a in the other
            # requesters' caches, and the entry's owner becomes r (through
            # the old tags: no entry was cleared on a conflict)
            m = (cache_tag == a) & others_rows[r]
            cache_tag.masked_fill_(m, -1)
            cache_seq.masked_fill_(m, 0)
            sf_owner.masked_fill_(sline, rbit)

        do_bisnp = need_victim or conflict
        extra = max(v_len - 1, 0)
        lat_bisnp = (cfg.bisnp_rtt_ps if do_bisnp else 0) + (
            extra * cfg.t_cache_ps + extra * extra * cfg.probe_conflict_ps
            if need_victim else 0)
        lat_wb = n_dirty * cfg.writeback_ps
        # int32, as the reference computes it (python int times int32)
        bus_occupancy = _i32(cfg.transfer_ps * (1 + v_len))
        if chit:
            latency = cfg.t_hit_ps
        elif F_lat is None:
            latency = (cfg.t_hit_ps + (t_bus_ready - t_hit) + cfg.transfer_ps
                       + cfg.miss_path_ps + cfg.t_sf_ps + lat_bisnp + lat_wb)
        else:
            latency = cfg.t_hit_ps + F_lat[i] + cfg.t_sf_ps

        # cache: the hit slot, else the first empty slot, else the least
        # recently used (first minimum), after the invalidation
        row_tag = cache_tag[r]
        if chit:
            slot = int(torch.argmax((row_tag == a).int()))
        else:
            empty = (row_tag < 0).nonzero().flatten().tolist()
            slot = empty[0] if empty else int(torch.argmin(cache_seq[r]))
        cache_tag[r, slot] = a
        cache_seq[r, slot] = seq

        # SF: upsert the entry for a on a cache miss (hits never reach the
        # device): the live entry, else the first free one
        if not chit:
            tgt = hits[0] if sf_hit else int(torch.argmax((sf_tag < 0).int()))
            sf_tag[tgt] = a
            sf_owner[tgt] |= rbit
            if w:
                sf_dirty[tgt] = True
            if not sf_hit:
                sf_ins[tgt] = seq
                lfi_count[a] += 1
            sf_acc[tgt] = seq
            present[a] = True

        clock[r] = t + latency
        if not chit:
            bus_free = t_bus_ready + bus_occupancy
        seq += 1
        bisnp += do_bisnp
        inval += n_clear + conflict

        # requester 0's SF lines and cache lines, counted again only when
        # the SF or requester 0's cache row may have changed
        if owner_lines is None or need_victim or conflict or not chit:
            owner_lines = int((((sf_owner & 1) > 0) & (sf_tag >= 0)).sum())
        if cached_lines is None or need_victim or conflict or r == 0:
            cached_lines = int((cache_tag[0] >= 0).sum())
        outs["latency"].append(latency)
        outs["cache_hit"].append(chit)
        outs["owner_lines"].append(owner_lines)
        outs["cached_lines"].append(cached_lines)
        if events:
            # BISnp targets: the owners (first R bits) of the cleared
            # lines, plus the other sharers on a write conflict
            outs["fab_issue"].append(t_hit)
            outs["bisnp_mask"].append(vmask | (others if conflict else 0))
            outs["inv_lines"].append(n_clear + conflict)
            outs["wb_lines"].append(n_dirty)
            outs["need_victim"].append(need_victim)
            outs["conflict"].append(conflict)
            outs["invblk_len"].append(v_len)

    result = {f: torch.tensor(v, dtype=OUT_DTYPES[f], device=dev)
              for f, v in outs.items()}
    scalar = functools.partial(torch.tensor, dtype=torch.int64, device=dev)
    return result, (cache_tag, cache_seq, sf_tag, sf_owner, sf_dirty,
                    sf_ins, sf_acc, lfi_count, present,
                    torch.tensor(clock, dtype=torch.int64, device=dev),
                    scalar(bus_free), scalar(seq), scalar(bisnp),
                    scalar(inval))


def check_states(jobs: list[ScanJob]):
    """Raise ``ValueError`` on a job whose starting state breaks what the
    line-indexed maps rest on: a valid tag (``>= 0``) outside ``[0, F)``,
    a line held by two SF entries, or a line held by two slots of one
    cache row.  The reference never makes such a state (its tags are
    addresses in ``[0, F)``, an SF upsert reuses the line's live entry, a
    cache row is filled only on a miss).  A few tensor ops a job on the
    state's device and one read back for all the jobs."""
    flags = []
    for job in jobs:
        foot = job.cfg.footprint
        cache_tag, sf_tag = job.state[0], job.state[2]
        flags.append(torch.stack([
            (sf_tag >= foot).any() | (cache_tag >= foot).any(),
            _repeats(sf_tag.reshape(1, -1), foot),
            _repeats(cache_tag, foot)]))
    if not flags:
        return
    for k, (outside, sf_rep, row_rep) in enumerate(
            torch.stack(flags).tolist()):
        if outside:
            raise ValueError(f"sf_scan job {k}: a tag outside "
                             f"[0, {jobs[k].cfg.footprint})")
        if sf_rep:
            raise ValueError(f"sf_scan job {k}: a line held by two SF "
                             f"entries")
        if row_rep:
            raise ValueError(f"sf_scan job {k}: a line held by two slots "
                             f"of one cache row")


def _repeats(tags, foot):
    """Whether a row of ``tags`` ((rows, n)) holds a line in [0, foot)
    twice (one count per row and line, negative tags counted nowhere)."""
    rows = tags.shape[0]
    t = tags.long()
    idx = torch.where((t >= 0) & (t < foot), t, foot) + (
        torch.arange(rows, device=t.device)[:, None] * (foot + 1))
    counts = torch.zeros(rows * (foot + 1), dtype=torch.int32,
                         device=t.device)
    counts.scatter_add_(0, idx.flatten(),
                        torch.ones(idx.numel(), dtype=torch.int32,
                                   device=t.device))
    return (counts.view(rows, foot + 1)[:, :foot] > 1).any()


LANES = 32
_NONE = (1 << 63) - 1  # "no index" of a lane with no candidate


def _ffs(x: int) -> int:
    """Index of the lowest set bit of ``x`` (> 0)."""
    return (x & -x).bit_length() - 1


def _i64(x: int) -> int:
    """``x`` wrapped to int64, as the kernel's int64 arithmetic wraps."""
    return (x + (1 << 63)) % (1 << 64) - (1 << 63)


class _Bits:
    """The kernel's two-level bitmap over n bits: ``lo[k]`` holds bits
    ``32k .. 32k + 31``, bit ``k & 31`` of ``hi[k >> 5]`` says whether
    ``lo[k]`` is nonzero, so the lowest set bit takes two reads (one more
    per 1,024 bits before it)."""

    def __init__(self, flags):
        n_lo = -(-len(flags) // 32)
        self.lo = [0] * n_lo
        self.hi = [0] * -(-n_lo // 32)
        for i, f in enumerate(flags):
            if f:
                self.set(i)

    def set(self, i):
        self.lo[i >> 5] |= 1 << (i & 31)
        self.hi[i >> 10] |= 1 << ((i >> 5) & 31)

    def clear(self, i):
        self.lo[i >> 5] &= ~(1 << (i & 31))
        if not self.lo[i >> 5]:
            self.hi[i >> 10] &= ~(1 << ((i >> 5) & 31))

    def lowest(self) -> int:
        for k, h in enumerate(self.hi):
            if h:
                w = (k << 5) + _ffs(h)
                return (w << 5) + _ffs(self.lo[w])
        return -1

    def any(self) -> bool:
        return any(self.hi)


def _lane_min(n, lane, key):
    """A lane's share of a search, as the kernel takes it: the first
    minimum of ``key(k)`` over items lane, lane + 32, ... < n, kept in four
    running minima (each takes every fourth of them, the tail the first)
    merged by (key, index)."""
    m = [(_NONE, _NONE)] * 4
    k = lane
    while k + 3 * LANES < n:
        for u in range(4):
            v = key(k + u * LANES)
            if v < m[u][0]:
                m[u] = (v, k + u * LANES)
        k += 4 * LANES
    while k < n:
        v = key(k)
        if v < m[0][0]:
            m[0] = (v, k)
        k += LANES
    return min(m)


def _warp_min(parts):
    """The 32 lanes' partials combined as the kernel's xor butterfly does:
    at each distance every lane keeps the lesser of its own tuple and lane
    ``l ^ m``'s ((key, index, ...): ties to the lower index)."""
    for m in (16, 8, 4, 2, 1):
        parts = [min(parts[ln], parts[ln ^ m]) for ln in range(LANES)]
    assert all(p == parts[0] for p in parts)
    return parts[0]


def sf_scan_indexed(jobs: list[ScanJob], *, check: bool = False) -> list:
    """The CUDA kernel's algorithm on the CPU, job by job: per job what
    `scan_one` returns, bit for bit.  With ``check`` it asserts after
    every step that each map, bitmap and running count equals a recount of
    the arrays.  Raises as `check_states` does on a state the maps cannot
    hold."""
    check_states(jobs)
    return [_scan_indexed(job, check) for job in jobs]


def _scan_indexed(job: ScanJob, check: bool):
    cfg = job.cfg
    check_config(cfg)
    dev = job.addr.device
    R, Cc, Cs, F = (cfg.n_requesters, cfg.cache_capacity, cfg.sf_capacity,
                    cfg.footprint)
    maxlen, policy = cfg.maxlen, cfg.policy
    (cache_tag, cache_seq, sf_tag, sf_owner, sf_dirty, sf_ins, sf_acc, lfi,
     present, clock) = (x.flatten().tolist() for x in job.state[:10])
    bus_free, seq, bisnp, inval = (int(x) for x in job.state[10:])
    own_mask = (1 << R) - 1

    # the preamble: maps, bitmaps and running counts from the state
    sf_map = [-1] * F
    cmap = [-1] * (R * F)
    for e, tag in enumerate(sf_tag):
        if tag >= 0:
            sf_map[tag] = e
    for k, tag in enumerate(cache_tag):
        if tag >= 0:
            cmap[(k // Cc) * F + tag] = k % Cc
    sf_bits = _Bits([tag < 0 for tag in sf_tag])
    c_bits = [_Bits([tag < 0 for tag in cache_tag[rr * Cc:(rr + 1) * Cc]])
              for rr in range(R)]
    n_free = sum(tag < 0 for tag in sf_tag)
    own0 = sum(tag >= 0 and o & 1 for tag, o in zip(sf_tag, sf_owner))
    cached0 = sum(tag >= 0 for tag in cache_tag[:Cc])
    # the order list (fifo, lifo: insertion stamps; lru, mru: access
    # stamps): the valid entries by (stamp, index), the index descending for
    # lifo and mru, so the victim is the head (fifo, lru) or the tail; kept
    # only where every valid stamp is below ``seq``
    by_acc = policy in (POLICY_CODES["lru"], POLICY_CODES["mru"])
    desc = policy in (POLICY_CODES["lifo"], POLICY_CODES["mru"])
    stamp = sf_acc if by_acc else sf_ins
    use_list = policy not in (POLICY_CODES["lfi"], POLICY_CODES["blp"]) \
        and all(tag < 0 or st < seq for tag, st in zip(sf_tag, stamp))
    links = _order(sf_tag, stamp, desc) if use_list else None

    def run_of(tag):
        # consecutive present lines after ``tag``, the reference's chain
        # (a clipped gather and the ``< F`` test)
        run = 1
        for d in range(1, maxlen):
            if run == d and present[min(max(tag + d, 0), F - 1)] \
                    and tag + d < F:
                run += 1
        return run

    def score_of(e, run):
        if policy == POLICY_CODES["fifo"]:
            return sf_ins[e]
        if policy == POLICY_CODES["lifo"]:
            return -sf_ins[e]
        if policy == POLICY_CODES["lru"]:
            return sf_acc[e]
        if policy == POLICY_CODES["mru"]:
            return -sf_acc[e]
        if policy == POLICY_CODES["lfi"]:
            cnt = lfi[min(max(sf_tag[e], 0), F - 1)]
            return _i64(cnt * BIG + (SMALL - sf_ins[e]))
        return _i64(-(run * BIG + sf_ins[e]))

    def invalidate(rr, c, line):
        nonlocal cached0
        cache_tag[rr * Cc + c] = -1
        cache_seq[rr * Cc + c] = 0
        cmap[rr * F + line] = -1
        c_bits[rr].set(c)
        cached0 -= rr == 0

    A, W, Rq = job.addr.tolist(), job.is_write.tolist(), job.rid.tolist()
    fab = job.fab.tolist() if job.fab is not None else None
    fields = OUT_FIELDS + (EVENT_FIELDS if job.events else ())
    outs = {f: [] for f in fields}
    for i in range(len(A)):
        a, w, r = A[i], W[i], Rq[i]
        rbit = 1 << r
        # ---- phase A, lane 0: one lookup each -------------------------
        t = clock[r]
        hit = cmap[r * F + a] >= 0
        e = sf_map[a]
        sf_hit = e >= 0
        owners = sf_owner[e] if sf_hit else 0
        others = owners & ~rbit
        conflict = sf_hit and w and others != 0
        need_victim = not sf_hit and n_free == 0

        # ---- a join for the victim: every lane searches its share -----
        victim = None
        if need_victim and (not use_list or check):
            victim = _warp_min([
                _lane_min(Cs, ln, lambda k: score_of(
                    k, run_of(sf_tag[k]) if policy == POLICY_CODES["blp"]
                    else 1))
                for ln in range(LANES)])[1]
        if need_victim and use_list:
            # the list's end, which is what the search finds
            assert victim in (None, links.tail if desc else links.head)
            victim = links.tail if desc else links.head

        # ---- phase B1, lane 0: the victim's clear, the conflict -------
        n_clear = n_dirty = vmask = v_len = 0
        if need_victim:
            v_tag = sf_tag[victim]
            v_len = min(run_of(v_tag), maxlen)
            for d in range(v_len):
                line = v_tag + d
                e3 = sf_map[line]
                if e3 < 0:
                    continue
                n_clear += 1
                n_dirty += sf_dirty[e3]
                vmask |= sf_owner[e3]
                own0 -= sf_owner[e3] & 1
                sf_tag[e3], sf_owner[e3], sf_dirty[e3] = -1, 0, False
                sf_ins[e3] = sf_acc[e3] = 0
                sf_map[line] = -1
                sf_bits.set(e3)
                n_free += 1
                if use_list:
                    links.unlink(e3)
                for rr in range(R):
                    c = cmap[rr * F + line]
                    if c >= 0:
                        invalidate(rr, c, line)
            # presence through indices clipped to F - 1, one offset after
            # another, the last offset to reach an index writing it (each
            # index keeps the value gathered before the writes)
            for j in range(maxlen):
                k = min(max(v_tag + j, 0), F - 1)
                if k < F - 1 or j == maxlen - 1:
                    present[k] = present[k] and not j < v_len
        if conflict:
            for rr in range(R):
                if rr != r and cmap[rr * F + a] >= 0:
                    invalidate(rr, cmap[rr * F + a], a)
            # the conflict owner, through the old tag (no clear on a
            # conflict)
            own0 += (rbit & 1) - (owners & 1)
            sf_owner[e] = rbit

        # ---- a join for the least-recent slot, where a miss finds its
        # row full after the clear (the clear only empties slots, so a full
        # row is as the step found it)
        lru = None
        if not hit and not c_bits[r].any():
            lru = _warp_min([
                _lane_min(Cc, ln, lambda c: cache_seq[r * Cc + c])
                for ln in range(LANES)])

        # ---- phase B2, lane 0: the fill, the upsert, the clocks --------
        # ---- a join for the least-recent slot, where a miss finds its
        # row full after the clear (the clear only empties slots, so a full
        # row is as the step found it)
        lru = None
        if not hit and not c_bits[r].any():
            lru = _warp_min([
                _lane_min(Cc, ln, lambda c: cache_seq[r * Cc + c])
                for ln in range(LANES)])

        # ---- phase B2, lane 0: the fill, the upsert, the clocks --------
        do_bisnp = need_victim or conflict
        extra = max(v_len - 1, 0)
        lat_bisnp = (cfg.bisnp_rtt_ps if do_bisnp else 0) + (
            extra * cfg.t_cache_ps + extra * extra * cfg.probe_conflict_ps
            if need_victim else 0)
        t_hit = t + cfg.t_hit_ps
        t_bus_ready = max(t_hit, bus_free)
        bus_occupancy = _i32(cfg.transfer_ps * (1 + v_len))
        if hit:
            latency = cfg.t_hit_ps
        elif fab is None:
            latency = (cfg.t_hit_ps + (t_bus_ready - t_hit) + cfg.transfer_ps
                       + cfg.miss_path_ps + cfg.t_sf_ps + lat_bisnp
                       + n_dirty * cfg.writeback_ps)
        else:
            latency = cfg.t_hit_ps + fab[i] + cfg.t_sf_ps

        # cache: the hit slot (0 if the line was invalidated), else the
        # lowest empty slot, else the least recent one
        if hit:
            slot = max(cmap[r * F + a], 0)
        else:
            slot = c_bits[r].lowest()
            if slot < 0:
                slot = lru[1]
        k = r * Cc + slot
        if cache_tag[k] != a:
            if cache_tag[k] >= 0:
                cmap[r * F + cache_tag[k]] = -1
            else:
                c_bits[r].clear(slot)
                cached0 += r == 0
            cmap[r * F + a] = slot
            cache_tag[k] = a
        cache_seq[k] = seq

        # SF upsert on a miss: the live entry, else the lowest free one
        if not hit:
            live = sf_map[a]
            have_entry = live >= 0
            tgt = live if have_entry else sf_bits.lowest()
            tgt = max(tgt, 0)
            old_tag, old_own = sf_tag[tgt], sf_owner[tgt]
            if old_tag != a:
                if old_tag >= 0:
                    sf_map[old_tag] = -1
                else:
                    sf_bits.clear(tgt)
                    n_free -= 1
                sf_map[a] = tgt
                sf_tag[tgt] = a
            own0 += ((old_own | rbit) & 1) - (old_tag >= 0 and old_own & 1)
            sf_owner[tgt] = old_own | rbit
            sf_dirty[tgt] = sf_dirty[tgt] or bool(w)
            if not have_entry:
                sf_ins[tgt] = seq
                lfi[a] += 1
            sf_acc[tgt] = seq
            # the new stamp is the greatest: the entry moves to the tail
            if use_list and (not have_entry or by_acc):
                if old_tag >= 0:
                    links.unlink(tgt)
                links.append(tgt)
            present[a] = True

        clock[r] = t + latency
        if not hit:
            bus_free = t_bus_ready + bus_occupancy
        seq += 1
        bisnp += do_bisnp
        inval += n_clear + conflict
        outs["latency"].append(latency)
        outs["cache_hit"].append(hit)
        outs["owner_lines"].append(own0)
        outs["cached_lines"].append(cached0)
        if job.events:
            outs["fab_issue"].append(t_hit)
            outs["bisnp_mask"].append((vmask & own_mask)
                                      | (others if conflict else 0))
            outs["inv_lines"].append(n_clear + conflict)
            outs["wb_lines"].append(n_dirty)
            outs["need_victim"].append(need_victim)
            outs["conflict"].append(conflict)
            outs["invblk_len"].append(v_len)
        if check:
            _recount(sf_tag, sf_owner, cache_tag, sf_map, cmap, sf_bits,
                     c_bits, n_free, own0, cached0, R, Cc, F)
            if use_list:
                want = _order(sf_tag, stamp, desc)
                assert (links.walk(), links.tail) == (want.walk(), want.tail)

    result = {f: torch.tensor(v, dtype=OUT_DTYPES[f], device=dev)
              for f, v in outs.items()}
    final = [torch.tensor(v, dtype=x.dtype, device=dev).reshape(x.shape)
             for v, x in zip((cache_tag, cache_seq, sf_tag, sf_owner,
                              sf_dirty, sf_ins, sf_acc, lfi, present, clock),
                             job.state[:10])]
    scalar = functools.partial(torch.tensor, dtype=torch.int64, device=dev)
    return result, (*final, scalar(bus_free), scalar(seq), scalar(bisnp),
                    scalar(inval))


class _Order:
    """The kernel's order list: ``before[k]`` / ``after[k]`` link the valid
    SF entries from ``head`` to ``tail`` (-1 at the ends)."""

    def __init__(self, order, n):
        self.before, self.after = [-1] * n, [-1] * n
        for x, y in zip(order, order[1:]):
            self.after[x], self.before[y] = y, x
        self.head = order[0] if order else -1
        self.tail = order[-1] if order else -1

    def unlink(self, k):
        prv, nxt = self.before[k], self.after[k]
        if prv >= 0:
            self.after[prv] = nxt
        else:
            self.head = nxt
        if nxt >= 0:
            self.before[nxt] = prv
        else:
            self.tail = prv

    def append(self, k):
        self.before[k], self.after[k] = self.tail, -1
        if self.tail >= 0:
            self.after[self.tail] = k
        else:
            self.head = k
        self.tail = k

    def walk(self):
        out, k = [], self.head
        while k >= 0:
            out.append(k)
            k = self.after[k]
        return out


def _order(sf_tag, stamp, desc):
    """The valid entries by (stamp, index), the index descending if
    ``desc``, linked."""
    valid = [k for k, tag in enumerate(sf_tag) if tag >= 0]
    return _Order(sorted(valid, key=lambda k: (stamp[k], -k if desc else k)),
                  len(sf_tag))


def _recount(sf_tag, sf_owner, cache_tag, sf_map, cmap, sf_bits, c_bits,
             n_free, own0, cached0, R, Cc, F):
    """Assert that the maps, bitmaps and running counts equal a recount of
    the arrays."""
    want = [-1] * F
    for e, tag in enumerate(sf_tag):
        if tag >= 0:
            assert want[tag] < 0, ("SF line held twice", tag)
            want[tag] = e
    assert sf_map == want, "SF map"
    want = [-1] * (R * F)
    for k, tag in enumerate(cache_tag):
        if tag >= 0:
            assert want[(k // Cc) * F + tag] < 0, ("cache line twice", k)
            want[(k // Cc) * F + tag] = k % Cc
    assert cmap == want, "cache maps"
    ref = _Bits([tag < 0 for tag in sf_tag])
    assert (sf_bits.lo, sf_bits.hi) == (ref.lo, ref.hi), "SF free bitmap"
    for rr in range(R):
        ref = _Bits([tag < 0 for tag in cache_tag[rr * Cc:(rr + 1) * Cc]])
        assert (c_bits[rr].lo, c_bits[rr].hi) == (ref.lo, ref.hi), (
            "empty-slot bitmap", rr)
    assert n_free == sum(tag < 0 for tag in sf_tag), "free entries"
    assert own0 == sum(tag >= 0 and o & 1
                       for tag, o in zip(sf_tag, sf_owner)), "owner_lines"
    assert cached0 == sum(tag >= 0 for tag in cache_tag[:Cc]), "cached_lines"
