"""Pure-Python event-driven reference simulator (oracle for `core.engine`).

The PyTorch port's copy of ``repro.core.ref_des``: it takes the port's
tensors (on any device), works on numpy copies, and returns numpy arrays.

This is, structurally, the C++ ESF: a classic discrete-event loop over channel
queues with FCFS-by-arrival arbitration.  It exists solely to prove that the
tensorized fixpoint engine computes the *exact* same integer schedule; the
test suite runs both on randomized topologies/workloads and asserts equality.

Semantics (must match `core.engine.simulate` bit-for-bit):
  * per channel, items are served in order of (arrival time, flat item index);
  * service time = bytes * 1e12 // (bw_MBps * 1e6)  [integer picoseconds];
  * half-duplex: when the served item's direction differs from the previous
    item's on that channel, the channel frees `turnaround_ps` later;
  * row-managed channels (DRAM banks) add row_hit/row_miss extra occupancy
    depending on the previously accessed row (cold access counts as miss);
  * flit-mode channels (`core.link_layer`) serialize whole flits —
    ``ceil(bytes / flit_payload) * flit_size`` wire bytes — stretched by the
    expected Go-Back-N CRC-replay factor ``(1 + replay_ppm/1e6)``, floored;
  * stochastic reliability (per-hop sampled tables in `Hops`): the hop's
    sampled replay wire bytes add to its flit-quantized wire bytes, and a
    hop with ``retrain_after_ps > 0`` puts its channel into a link-down
    interval at departure — subsequent grants on that channel start no
    earlier than ``down_until`` (the engine's scan-carry state, mirrored
    here as per-channel state so equality stays bit-exact per seed);
  * a *link-down marker* — a valid zero-byte hop with ``retrain_after_ps
    > 0`` (`link_layer.insert_retrain_markers`, the full-duplex partner
    of a retraining channel) — takes no service and occupies nothing: it
    contributes a down interval (its arrival + retrain) that delays
    exactly the channel's items *after it* in the global FCFS key order
    (arrival, flat index) — the engine's segmented-scan semantics.  It is
    processed punctually at its arrival (never queued), so its own
    transaction chain continues undelayed;
  * fork/join (per-row ``join_id`` / ``join_wait`` / ``join_arity`` in
    `Hops`): a waiter row is held back until every contributor of its
    group has completed, then issues at ``max(issue, slowest contributor
    completion)`` — max-of-arrivals join semantics.  The release is
    event-driven: the group's ``join_arity``-th completion triggers it,
    and ``join_arity`` is validated against the actual contributor count
    (the lowering contract).  A release lands at exactly the completing
    row's timestamp, so all arrivals of a timestamp — including cascaded
    releases — are drained before any channel serves (see the batch loop);
  * arrival at hop h+1 = departure at hop h + fixed_after[h].
"""

from __future__ import annotations

import heapq

import numpy as np

from .engine import (Channels, Hops, Schedule, resolve_device, to_device,
                     to_host)


def ref_schedule(ref: dict, device="cuda", rounds: int = 0) -> Schedule:
    """Wrap a `simulate_ref` result dict as a `Schedule` on ``device`` so
    every post-schedule reduction (`channel_stats`, `request_stats`) runs
    unchanged against the oracle — the metric-equality cross-check.
    ``rounds`` records the fixpoint rounds spent before a fallback."""
    dev = resolve_device(device)
    return Schedule(
        arrive=to_device(ref["arrive"], dev),
        start=to_device(ref["start"], dev),
        depart=to_device(ref["depart"], dev),
        complete=to_device(ref["complete"], dev),
        rounds=rounds,
        converged=True,
        residual_ps=0,
    )


def simulate_ref(hops: Hops, channels: Channels, issue_ps,
                 carry=None) -> dict:
    """``carry`` (`engine.StreamCarry`, streaming windows) seeds the
    per-channel ``free_at`` state — busy-until, last direction, last DRAM
    row, down-until — and the per-group join maxes of contributors that
    retired in earlier windows, mirroring the engine's carry-seeded scan so
    windowed oracle fallbacks stay bit-exact against the monolithic run."""
    chan = to_host(hops.channel)
    nbytes = to_host(hops.nbytes)
    direction = to_host(hops.direction)
    row = to_host(hops.row)
    fixed = to_host(hops.fixed_after_ps)
    valid = to_host(hops.valid)
    issue = to_host(issue_ps)
    bw = to_host(channels.bw_MBps)
    turn = to_host(channels.turnaround_ps)
    rhit = to_host(channels.row_hit_ps)
    rmiss = to_host(channels.row_miss_ps)
    fsize = (to_host(channels.flit_size)
             if channels.flit_size is not None else None)
    fpay = (to_host(channels.flit_payload)
            if channels.flit_payload is not None else None)
    rppm = (to_host(channels.replay_ppm)
            if channels.replay_ppm is not None else None)
    extra_wire = (to_host(hops.extra_wire_bytes)
                  if hops.extra_wire_bytes is not None else None)
    retrain = (to_host(hops.retrain_after_ps)
               if hops.retrain_after_ps is not None else None)
    join_id = (to_host(hops.join_id)
               if hops.join_id is not None else None)
    join_wait = (to_host(hops.join_wait)
                 if hops.join_wait is not None else None)
    join_arity = (to_host(hops.join_arity)
                  if hops.join_arity is not None else None)

    def ser_time(p: int, hop: int, c: int) -> int:
        nb = int(nbytes[p, hop])
        if fsize is None or fsize[c] == 0:
            return (nb * 1_000_000) // int(bw[c])
        wire = -(-nb // max(int(fpay[c]), 1)) * int(fsize[c])
        if extra_wire is not None:
            wire += int(extra_wire[p, hop])
        fser = (wire * 1_000_000) // int(bw[c])
        if rppm is not None:
            fser = (fser * (1_000_000 + int(rppm[c]))) // 1_000_000
        return fser

    n, h = chan.shape
    arrive = np.zeros((n, h + 1), dtype=np.int64)
    start = np.zeros((n, h), dtype=np.int64)
    depart = np.zeros((n, h), dtype=np.int64)

    # channel state
    free_at = {}      # channel -> (time, last_dir, last_row, down_until)
    queues = {}       # channel -> heap of (arrival, flat_idx, pkt, hop)
    markers = {}      # channel -> list of ((arrival, flat_idx), down_end)
    jseed = None
    if carry is not None:
        c_dep = to_host(carry.depart_ps)
        c_dir = to_host(carry.last_dir)
        c_row = to_host(carry.last_row)
        c_down = to_host(carry.down_until_ps)
        for c in range(c_dep.shape[0]):
            free_at[c] = (int(c_dep[c]), int(c_dir[c]), int(c_row[c]),
                          int(c_down[c]))
        if carry.join_seed_ps is not None:
            jseed = to_host(carry.join_seed_ps)

    # fork/join state: contributor counts, running (count, max-completion)
    # per group, and the waiter rows each group releases on completion
    if join_id is not None:
        if max(int(join_id.max()), int(join_wait.max())) >= n:
            raise ValueError(
                f"join group ids must be < n_rows ({n}): the engine "
                "resolves group maxes with a row-indexed scatter")
        n_contrib = np.zeros(n, np.int64)
        for p in range(n):
            if join_id[p] >= 0:
                n_contrib[join_id[p]] += 1
        waiters = {}
        for p in range(n):
            g = int(join_wait[p])
            if g < 0:
                continue
            if int(join_arity[p]) != int(n_contrib[g]):
                raise ValueError(
                    f"row {p}: join_arity {int(join_arity[p])} != "
                    f"{int(n_contrib[g])} contributors of group {g}")
            if n_contrib[g] > 0:      # empty groups never gate (engine: max
                waiters.setdefault(g, []).append(p)   # over nothing == 0)
        jdone = {}                    # group -> [completions seen, max comp]
        if jseed is not None:
            # carried group maxes: completions of contributors that retired
            # in earlier windows count toward the release max (their arity
            # share was already subtracted by the streaming driver)
            for g in range(n):
                if jseed[g] > 0:
                    jdone[g] = (0, int(jseed[g]))
        completed = np.zeros(n, bool)
        released = np.zeros(n, bool)

    # event heap: (time, seq, kind, payload)  kind 0=arrival at hop, 1=channel free
    ev = []
    seq = 0
    for p in range(n):
        if join_id is not None and int(join_wait[p]) >= 0:
            g = int(join_wait[p])
            if n_contrib[g] > 0:
                continue              # held until the group's join releases
            if jseed is not None and jseed[g] > 0:
                # every contributor already retired: the gate is the
                # carried max, resolvable at push time
                arrive[p, 0] = max(int(issue[p]), int(jseed[g]))
                heapq.heappush(ev, (int(arrive[p, 0]), seq, 0, (p, 0)))
                seq += 1
                continue
        arrive[p, 0] = issue[p]
        heapq.heappush(ev, (int(issue[p]), seq, 0, (p, 0)))
        seq += 1

    def try_serve(c, now):
        nonlocal seq
        q = queues.get(c)
        if not q:
            return
        t_free, last_dir, last_row, down_until = free_at.get(c, (0, -1, -2, 0))
        if t_free > now:
            return
        # FCFS by (arrival, flat index); only items that have arrived
        arr, fi, p, hop = q[0]
        if arr > now:
            heapq.heappush(ev, (int(arr), seq, 1, c)); seq += 1
            return
        heapq.heappop(q)
        gap = int(turn[c]) if (last_dir != -1 and direction[p, hop] != last_dir) else 0
        # a retraining channel grants nothing before down_until (the gap is
        # NOT re-paid on top of it: mirror of the engine's max(floor, down));
        # link-down markers apply only to items after them in FCFS key order.
        # A grant never starts before ``now`` (st >= now by construction),
        # so markers whose down interval already ended are dead — prune
        # them to keep the scan short on retrain-heavy runs.
        down = down_until
        ml = markers.get(c)
        if ml:
            ml[:] = [m for m in ml if m[1] > now]
            for key, dend in ml:
                if key < (arr, p * h + hop):
                    down = max(down, dend)
        st = max(arr, t_free + gap, down)
        ser = ser_time(p, hop, c)
        extra = 0
        r = int(row[p, hop])
        if r >= 0:
            extra = int(rhit[c]) if r == last_row else int(rmiss[c])
        dp = st + ser + extra
        start[p, hop] = st
        depart[p, hop] = dp
        if retrain is not None and retrain[p, hop] > 0:
            down_until = max(down_until, dp + int(retrain[p, hop]))
        free_at[c] = (dp, int(direction[p, hop]),
                      r if r >= 0 else last_row, down_until)
        arrive[p, hop + 1] = dp + int(fixed[p, hop])
        heapq.heappush(ev, (int(arrive[p, hop + 1]), seq, 0, (p, hop + 1))); seq += 1
        heapq.heappush(ev, (dp, seq, 1, c)); seq += 1

    def complete_row(p):
        """Row p reached its completion column: feed its join group and
        release the group's waiters once the arity-th contributor lands."""
        nonlocal seq
        if join_id is None or completed[p]:
            return
        completed[p] = True
        g = int(join_id[p])
        if g < 0:
            return
        cnt, gmax = jdone.get(g, (0, 0))
        cnt, gmax = cnt + 1, max(gmax, int(arrive[p, h]))
        jdone[g] = (cnt, gmax)
        if cnt < n_contrib[g]:
            return
        for w in waiters.get(g, ()):
            if released[w]:
                continue
            released[w] = True
            arrive[w, 0] = max(int(issue[w]), gmax)
            heapq.heappush(ev, (int(arrive[w, 0]), seq, 0, (w, 0)))
            seq += 1

    # Events are processed in *timestamp batches*: every event at the
    # current time is drained — arrivals enqueued, link-down markers
    # registered, join releases cascaded — before any channel serves.
    # Within one timestamp the serve order is then fully determined by the
    # queue key (arrival, flat index), independent of event delivery
    # order — exactly the engine's global sort order, which is what makes
    # equality bit-exact even when many arrivals tie (regular traffic like
    # the coherence lowering produces dense ties).  Arrivals are processed
    # one pop at a time (not pre-collected) because a join release lands at
    # exactly the completing row's timestamp: the released row's first hop
    # must enter its channel queue before this timestamp's serves, or a
    # same-arrival larger-flat-index item would overtake it.
    while ev:
        now = ev[0][0]
        serves = []
        while ev and ev[0][0] == now:
            _, _, kind, payload = heapq.heappop(ev)
            if kind != 0:
                serves.append(payload)
                continue
            p, hop = payload
            # skip padded hops and zero-byte packets: the latter ride a side
            # channel (command path) — instant pass-through, no bus occupancy,
            # no direction turn (mirror of the engine semantics).  A link-down
            # marker (valid, zero-byte, retrain > 0) is also a pass-through,
            # but registers its down interval for the channel's later-keyed
            # items on the way past.
            while hop < h and (not valid[p, hop] or nbytes[p, hop] == 0):
                if (valid[p, hop] and retrain is not None
                        and retrain[p, hop] > 0):
                    a = int(arrive[p, hop])
                    markers.setdefault(int(chan[p, hop]), []).append(
                        ((a, p * h + hop), a + int(retrain[p, hop])))
                start[p, hop] = arrive[p, hop]
                depart[p, hop] = arrive[p, hop]
                arrive[p, hop + 1] = arrive[p, hop] + (
                    int(fixed[p, hop]) if valid[p, hop] else 0
                )
                hop += 1
            if hop >= h:
                complete_row(p)
                continue
            c = int(chan[p, hop])
            queues.setdefault(c, [])
            heapq.heappush(queues[c],
                           (int(arrive[p, hop]), p * h + hop, p, hop))
            serves.append(c)
        for c in serves:
            try_serve(c, now)

    if join_id is not None:
        stuck = [p for p in range(n)
                 if int(join_wait[p]) >= 0 and n_contrib[int(join_wait[p])] > 0
                 and not released[p]]
        if stuck:
            raise RuntimeError(
                f"join deadlock: rows {stuck[:8]} were never released — "
                "the join groups do not form a DAG")

    return {
        "arrive": arrive,
        "start": start,
        "depart": depart,
        "complete": arrive[:, h],
    }
