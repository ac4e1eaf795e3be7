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
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

POLICY_CODES = {"fifo": 0, "lru": 1, "lfi": 2, "lifo": 3, "mru": 4, "blp": 5}
BIG = 1 << 40
SMALL = 1 << 36
# InvBlk runs clear at most this many lines (the kernel keeps the cleared
# lines of a step in one 64-bit mask); CXL's InvBlk has 1 to 4
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
