"""Critical-path extraction and bottleneck blame attribution, PyTorch port.

The counterpart of ``repro.core.critical_path``, name for name and in the
same order.  `core.telemetry` answers *how much* time each request spent
queueing, serializing, or stalled; this module answers *which* event gated
it.  For every request in a resolved `engine.Schedule` it reconstructs the
chain of gating events: the FCFS predecessor on each hop's channel, the
request's own previous hop, the slowest fork/join contributor, or a
retraining ``down_until`` release.  The reconstruction replays the engine's
segmented scan **with argmax backpointers** on the host, a pure observer in
the `engine.replay_round` sense: the schedule is a fixed point of the round
map, so one replay reproduces every ``start``/``depart`` bit for bit
(asserted under ``check=True``) and the schedule itself is never
recomputed.

From the backpointer forest it derives

  * per-request **critical paths**: chains of typed edges whose time
    contributions sum *exactly* to ``complete − issue`` (the conservation
    invariant; edges are clipped against the request's issue time so
    priority-inverted predecessors that started before the request even
    issued cannot over-attribute),
  * aggregated **blame tables** per channel × edge kind with top-k
    bottleneck ranking and per-switch rollups (`Blame.by_switch`), and
  * coz-style **what-if estimates**: `speedup_if(bp, channel, factor)`
    re-propagates event times along the frozen backpointer DAG with the
    target channel's serialization scaled, without re-running contention.

As in the reference, everything here is host-side NumPy over a pulled-back
schedule.  The inputs are the port's tables and schedules, tensors on any
device (on the card the schedule comes from the fused serve-round kernel);
each field is pulled to the host once (`engine.to_host`), never item by
item, and every output is the reference's type: NumPy arrays, `PathEdge`
tuples of ints, dicts.  The per-item loops read Python lists of those
arrays, which is the same arithmetic on the same int64 values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .engine import Channels, Hops, Schedule, to_host

# Edge kinds of a critical path.  ISSUE terminates every path (the walk
# reached an event at or before the request's own issue time); JOIN crosses
# from a waiter row to its slowest fork/join contributor; QUEUE crosses to
# the FCFS predecessor whose depart (+ turnaround) floored the grant;
# RETRAIN crosses to the item/marker whose down interval floored it; WIRE is
# the item's own serialization, ROW its row-buffer penalty, FIXED the
# post-transmission fixed latency between consecutive hops of one row.
K_ISSUE, K_JOIN, K_QUEUE, K_RETRAIN, K_WIRE, K_ROW, K_FIXED = range(7)
KIND_NAMES = ("issue", "join", "queue", "retrain", "wire", "row", "fixed")
N_KINDS = len(KIND_NAMES)

# grant-time binding of a serving item (Backpointers.bind)
B_NONE, B_ARRIVE, B_QUEUE, B_RETRAIN = -1, 0, 1, 2


class PathEdge(NamedTuple):
    """One edge of a request's critical path.

    ``row``/``hop`` is the gated item (``hop == -1`` for row-level JOIN /
    ISSUE edges); ``src_row``/``src_hop`` the event the walk crosses to
    (``-1`` when the edge stays within the item).  ``channel`` is the
    channel billed (-1 for channel-less kinds: issue, join, fixed).
    ``t_lo``/``t_hi`` bound the edge in time; ``ps`` is the *clipped*
    contribution: per request, contributions sum exactly to
    ``complete − issue``.
    """

    kind: int
    row: int
    hop: int
    src_row: int
    src_hop: int
    channel: int
    t_lo: int
    t_hi: int
    ps: int


class Backpointers:
    """Frozen argmax backpointers of one resolved schedule (host arrays).

    Produced by `extract_backpointers`; consumed by `critical_path`,
    `blame`, and `speedup_if`.  All arrays are NumPy; times int64
    picoseconds, exactly the engine's.
    """

    def __init__(self, *, n, h, c, issue, arrive, start, depart, valid,
                 serving, channel, wire, row_extra, fixed, bind, qpred_row,
                 qpred_hop, rsrc_row, rsrc_hop, gate_row):
        self.n, self.h, self.c = n, h, c
        self.issue = issue          # (N,)
        self.arrive = arrive        # (N, H+1)
        self.start = start          # (N, H)
        self.depart = depart        # (N, H)
        self.complete = arrive[:, h]
        self.valid = valid          # (N, H) hop exists
        self.serving = serving      # (N, H) occupies its channel
        self.channel = channel      # (N, H)
        self.wire = wire            # (N, H) serialization ps
        self.row_extra = row_extra  # (N, H) row-buffer penalty ps
        self.fixed = fixed          # (N, H) fixed_after ps
        self.bind = bind            # (N, H) B_* grant binding
        self.qpred_row = qpred_row  # (N, H) FCFS predecessor item
        self.qpred_hop = qpred_hop
        self.rsrc_row = rsrc_row    # (N, H) retrain-source item/marker
        self.rsrc_hop = rsrc_hop
        self.gate_row = gate_row    # (N,) binding join contributor, -1
        self._lists = None

    def _py_lists(self) -> dict:
        """The arrays the walks read, as nested Python lists (built once)."""
        if self._lists is None:
            self._lists = {name: getattr(self, name).tolist() for name in (
                "issue", "arrive", "start", "depart", "valid", "serving",
                "channel", "wire", "row_extra", "fixed", "bind", "qpred_row",
                "qpred_hop", "rsrc_row", "rsrc_hop", "gate_row")}
        return self._lists


def _host(x, dtype) -> np.ndarray:
    """A host copy of a tensor (any device) or array, as ``dtype``."""
    return np.array(to_host(x), dtype=dtype)


def _np_wire_ser_ps(nbytes, ch: Channels, chan_clipped, extra_wire=None):
    """NumPy port of `engine.wire_ser_ps`, bit-exact for int64 inputs."""
    bw = to_host(ch.bw_MBps)[chan_clipped]
    base = (nbytes * 1_000_000) // bw
    if ch.flit_size is None:
        return base
    fsize = to_host(ch.flit_size)[chan_clipped]
    fpay = np.maximum(to_host(ch.flit_payload)[chan_clipped], 1)
    wire = ((nbytes + fpay - 1) // fpay) * fsize
    if extra_wire is not None:
        wire = wire + extra_wire
    fser = (wire * 1_000_000) // bw
    if ch.replay_ppm is not None:
        ppm = to_host(ch.replay_ppm)[chan_clipped]
        scale = 1_000_000 + ppm
        q, r = fser // 1_000_000, fser % 1_000_000
        fser = q * scale + (r * scale) // 1_000_000
    return np.where(fsize > 0, fser, base)


def extract_backpointers(hops: Hops, channels: Channels, sched: Schedule,
                         issue_ps, check: bool = True) -> Backpointers:
    """Replay the engine's scan with argmax backpointers (pure observer).

    Walks the lexsorted item sequence exactly as the engine's round does
    (same segment keys, same carried per-channel state, same marker
    semantics), recording for every serving item which term of
    ``start = max(arrive, depart_prev + gap, down_until)`` bound the grant
    (ties prefer ARRIVE, then QUEUE: only strictly-gating events become
    cross edges).  ``check=True`` asserts the replay reproduces the
    schedule's ``start``/``depart``/``arrive`` columns and the join gates
    bit for bit, i.e. that the observer did not perturb anything.

    Streaming-window schedules (seeded carries) are not supported here.
    """
    n, h = hops.channel.shape
    c = int(channels.bw_MBps.shape[0])
    k = n * h

    arrive = _host(sched.arrive, np.int64)
    start_ref = _host(sched.start, np.int64)
    depart_ref = _host(sched.depart, np.int64)
    issue = _host(issue_ps, np.int64)

    chan2 = _host(hops.channel, np.int64)
    valid2 = _host(hops.valid, bool)
    nbytes2 = _host(hops.nbytes, np.int64)
    dir2 = _host(hops.direction, np.int64)
    row2 = _host(hops.row, np.int64)
    fixed2 = _host(hops.fixed_after_ps, np.int64)
    extra2 = (_host(hops.extra_wire_bytes, np.int64)
              if hops.extra_wire_bytes is not None else None)
    retr2 = (_host(hops.retrain_after_ps, np.int64)
             if hops.retrain_after_ps is not None else None)
    has_retrain = retr2 is not None

    flat_arrive = arrive[:, :h].reshape(k)
    flat_chan = chan2.reshape(k)
    flat_valid = valid2.reshape(k)
    flat_bytes = nbytes2.reshape(k)
    sort_chan = np.where(flat_valid, flat_chan, c)
    order = np.lexsort((np.arange(k), flat_arrive, sort_chan))

    clip_c = np.minimum(flat_chan, c - 1)
    flat_ser = _np_wire_ser_ps(
        flat_bytes, channels, clip_c,
        extra_wire=extra2.reshape(k) if extra2 is not None else None)

    # the loop reads Python lists: the same int64 values, read per item
    chan_l, valid_l = flat_chan.tolist(), flat_valid.tolist()
    arr_l, bytes_l = flat_arrive.tolist(), flat_bytes.tolist()
    dir_l, row_l = dir2.reshape(k).tolist(), row2.reshape(k).tolist()
    retr_l = retr2.reshape(k).tolist() if has_retrain else None
    ser_l = flat_ser.tolist()
    turn_l = to_host(channels.turnaround_ps)[clip_c].tolist()
    rhit_l = to_host(channels.row_hit_ps)[clip_c].tolist()
    rmiss_l = to_host(channels.row_miss_ps)[clip_c].tolist()

    start_out = list(arr_l)
    depart_out = list(arr_l)
    wire_out = [0] * k
    rowx_out = [0] * k
    bind_out = [B_NONE] * k
    qpred_out = [-1] * k
    rsrc_out = [-1] * k

    # carried scan state, exactly the engine round's (plus the argmax
    # shadows: which item set the depart frontier / the down interval)
    pc, pd, pdir, prow, pdown = -1, 0, -1, -2, 0
    p_item = -1       # flat index behind pd (-1 after a marker head reset)
    pdown_src = -1    # flat index behind pdown

    for f in order.tolist():
        ch_f = chan_l[f]
        v0 = valid_l[f]
        arr = arr_l[f]
        nb = bytes_l[f]
        retrain = retr_l[f] if has_retrain else 0
        marker = has_retrain and v0 and nb == 0 and retrain > 0
        srv = v0 and nb > 0
        if not (srv or marker):
            continue  # padded or pass-through: outputs stay at arrive
        same = ch_f == pc
        drn = dir_l[f]
        if srv:
            gap = turn_l[f] if (same and drn != pdir) else 0
            floor_q = pd + gap
            seg_down = (pdown if same else 0) if has_retrain else 0
            nodown = max(arr, floor_q) if same else arr
            start = max(nodown, seg_down) if same else arr
            row = row_l[f]
            row_extra = ((rhit_l[f] if (same and row == prow)
                          else rmiss_l[f]) if row >= 0 else 0)
            ser = ser_l[f]
            depart = start + ser + row_extra
            start_out[f] = start
            depart_out[f] = depart
            wire_out[f] = ser
            rowx_out[f] = row_extra
            if start == arr:
                bind_out[f] = B_ARRIVE
            elif start == nodown:
                bind_out[f] = B_QUEUE
                if p_item < 0:
                    raise AssertionError(
                        "queue-bound grant with no predecessor item")
                qpred_out[f] = p_item
            else:
                bind_out[f] = B_RETRAIN
                if pdown_src < 0:
                    raise AssertionError(
                        "retrain-bound grant with no down source")
                rsrc_out[f] = pdown_src
            pc, pd, pdir = ch_f, depart, drn
            if row >= 0:
                prow = row
            p_item = f
        else:  # link-down marker: occupies nothing, raises down_until
            head = not same
            pc = ch_f
            if head:
                pd, pdir, prow, p_item = 0, drn, -2, -1
            depart = arr
        if has_retrain:
            seg_down = pdown if same else 0
            seg_src = pdown_src if same else -1
            contrib = depart + retrain if retrain > 0 else 0
            if contrib > seg_down:
                pdown, pdown_src = contrib, f
            else:
                pdown, pdown_src = seg_down, seg_src

    start2 = np.asarray(start_out, np.int64).reshape(n, h)
    depart2 = np.asarray(depart_out, np.int64).reshape(n, h)
    serving2 = valid2 & (nbytes2 > 0)

    # fork/join gates: reproduce the engine's join gate at the fixpoint and
    # record the argmax contributor of every gate that strictly delayed its
    # waiter
    gate_row = np.full(n, -1, np.int64)
    if hops.join_id is not None:
        jid = _host(hops.join_id, np.int64)
        jwait = _host(hops.join_wait, np.int64)
        comp = arrive[:, h]
        gmax = np.zeros(n, np.int64)
        argrow = np.full(n, -1, np.int64)
        for r in np.nonzero(jid >= 0)[0]:  # ascending: ties pick lowest row
            g = int(jid[r])
            if comp[r] > gmax[g]:
                gmax[g], argrow[g] = comp[r], r
        waiters = jwait >= 0
        gclip = np.clip(jwait, 0, n - 1)
        gate = np.where(waiters, np.maximum(issue, gmax[gclip]), issue)
        binds = waiters & (gmax[gclip] > issue)
        gate_row[binds] = argrow[gclip[binds]]
        if check and not np.array_equal(arrive[:, 0], gate):
            raise AssertionError("join-gate replay diverged from schedule")
    elif check and not np.array_equal(arrive[:, 0], issue):
        raise AssertionError("issue replay diverged from schedule")

    if check:
        if not np.array_equal(start2, start_ref):
            raise AssertionError("backpointer replay diverged: start")
        if not np.array_equal(depart2, depart_ref):
            raise AssertionError("backpointer replay diverged: depart")
        prop = arrive[:, 0]
        for j in range(h):
            prop = np.where(valid2[:, j], depart2[:, j] + fixed2[:, j], prop)
            if not np.array_equal(arrive[:, j + 1], prop):
                raise AssertionError("backpointer replay diverged: arrive")

    qp = np.asarray(qpred_out, np.int64)
    rs = np.asarray(rsrc_out, np.int64)
    return Backpointers(
        n=n, h=h, c=c, issue=issue, arrive=arrive, start=start2,
        depart=depart2, valid=valid2, serving=serving2, channel=chan2,
        wire=np.asarray(wire_out, np.int64).reshape(n, h),
        row_extra=np.asarray(rowx_out, np.int64).reshape(n, h),
        fixed=fixed2, bind=np.asarray(bind_out, np.int8).reshape(n, h),
        qpred_row=np.where(qp >= 0, qp // h, -1).reshape(n, h),
        qpred_hop=np.where(qp >= 0, qp % h, -1).reshape(n, h),
        rsrc_row=np.where(rs >= 0, rs // h, -1).reshape(n, h),
        rsrc_hop=np.where(rs >= 0, rs % h, -1).reshape(n, h),
        gate_row=gate_row,
    )


def critical_path(bp: Backpointers, r: int) -> list[PathEdge]:
    """The chain of gating events behind request ``r``'s completion.

    Walks backward from the completion event along the frozen backpointers,
    emitting one `PathEdge` per gating interval.  Every contribution is
    clipped against ``issue[r]`` (events wholly before the request issued
    contribute nothing, and the walk stops there), so

        sum(e.ps for e in path) == complete[r] − issue[r]

    holds exactly: the conservation invariant `blame` re-asserts.
    """
    L = bp._py_lists()
    issue_r = L["issue"][r]
    h = bp.h
    valid, serving, channel = L["valid"], L["serving"], L["channel"]
    start, depart, wire, bind = L["start"], L["depart"], L["wire"], L["bind"]

    def clip(lo, hi):
        return max(hi, issue_r) - max(lo, issue_r)

    edges: list[PathEdge] = []
    tag, p, j = "A", int(r), h
    t = L["arrive"][r][h]
    limit = 16 * (bp.n * (h + 2) + 8)
    for _ in range(limit):
        if t <= issue_r:
            edges.append(PathEdge(K_ISSUE, p, -1, -1, -1, -1, t, t, 0))
            break
        if tag == "A":
            if j == 0:
                g = L["gate_row"][p]
                if g >= 0:  # join gate bound: cross to slowest contributor
                    edges.append(PathEdge(K_JOIN, p, -1, g, -1, -1, t, t, 0))
                    tag, p, j = "A", g, h
                else:  # reached an issue event: terminal edge absorbs rest
                    edges.append(PathEdge(
                        K_ISSUE, p, -1, -1, -1, -1, issue_r, t,
                        clip(issue_r, t)))
                    break
            else:
                jj = j - 1
                if valid[p][jj]:
                    lo = depart[p][jj]
                    ps = clip(lo, t)
                    if ps > 0:
                        edges.append(PathEdge(
                            K_FIXED, p, jj, -1, -1, -1, lo, t, ps))
                    tag, j, t = "D", jj, lo
                else:
                    j = jj  # padded hop passes the arrival through
        elif tag == "D":
            if serving[p][j]:
                st = start[p][j]
                mid = st + wire[p][j]
                cch = channel[p][j]
                if t > mid:
                    edges.append(PathEdge(
                        K_ROW, p, j, -1, -1, cch, mid, t, clip(mid, t)))
                if mid > st:
                    edges.append(PathEdge(
                        K_WIRE, p, j, -1, -1, cch, st, mid, clip(st, mid)))
                tag, t = "S", st
            else:
                tag = "A"  # marker / pass-through: depart == arrive
        else:  # "S": how was the grant bound?
            b = bind[p][j]
            cch = channel[p][j]
            if b == B_QUEUE:
                pr, pj = L["qpred_row"][p][j], L["qpred_hop"][p][j]
                lo = depart[pr][pj]
                edges.append(PathEdge(
                    K_QUEUE, p, j, pr, pj, cch, lo, t, clip(lo, t)))
                tag, p, j, t = "D", pr, pj, lo
            elif b == B_RETRAIN:
                sr, sj = L["rsrc_row"][p][j], L["rsrc_hop"][p][j]
                lo = depart[sr][sj]
                edges.append(PathEdge(
                    K_RETRAIN, p, j, sr, sj, cch, lo, t, clip(lo, t)))
                tag, p, j, t = "D", sr, sj, lo
            else:  # ARRIVE: start == arrive, zero-width move
                tag = "A"
    else:
        raise RuntimeError("critical-path walk did not terminate")
    edges.reverse()
    return edges


def critical_paths(bp: Backpointers, rows=None) -> list[list[PathEdge]]:
    """Critical paths of ``rows`` (default: every request)."""
    if rows is None:
        rows = range(bp.n)
    return [critical_path(bp, int(r)) for r in rows]


def path_total(path) -> int:
    """Sum of a path's edge contributions (== complete − issue)."""
    return sum(e.ps for e in path)


class Blame:
    """Aggregated critical-path blame: channel × edge-kind table.

    ``table`` has shape (C+1, N_KINDS); row ``C`` collects channel-less
    edges (issue / join / fixed).  All entries are int64 picoseconds and
    sum to ``total_ps``: the summed ``complete − issue`` of the requests
    aggregated (the conservation invariant, asserted at build time).
    """

    def __init__(self, table: np.ndarray, n_requests: int, total_ps: int):
        self.table = table
        self.n_requests = n_requests
        self.total_ps = total_ps

    def by_kind(self) -> dict[str, int]:
        tot = self.table.sum(axis=0)
        return {KIND_NAMES[i]: int(tot[i]) for i in range(N_KINDS)}

    def by_channel(self) -> np.ndarray:
        """(C+1,) blame per channel (last row: channel-less edges)."""
        return self.table.sum(axis=1)

    def top(self, k: int = 5) -> list[dict]:
        """Top-k (channel, kind) bottleneck cells, largest blame first."""
        c1 = self.table.shape[0]
        flat = self.table.reshape(-1)
        order = np.argsort(flat, kind="stable")[::-1][:k]
        out = []
        denom = max(self.total_ps, 1)
        for ix in order:
            ch, kd = divmod(int(ix), N_KINDS)
            ps = int(flat[ix])
            if ps <= 0:
                break
            out.append({
                "channel": ch if ch < c1 - 1 else None,
                "kind": KIND_NAMES[kd],
                "ps": ps,
                "share": ps / denom,
            })
        return out

    def by_switch(self, graph) -> dict[int, int]:
        """Roll channel blame up to fabric nodes, largest first.

        A link channel's blame implicates both endpoint nodes; a service
        channel implicates its memory device.  Channel-less blame (issue /
        join / fixed) is not attributed to any node.
        """
        chan_nodes: dict[int, set[int]] = {}
        for (u, v), (ch_ix, _) in graph._edge.items():
            chan_nodes.setdefault(int(ch_ix), set()).update((int(u), int(v)))
        svc = np.asarray(graph._service_chan)
        for m in range(svc.shape[0]):
            for bk in range(svc.shape[1]):
                if svc[m, bk] >= 0:
                    chan_nodes.setdefault(int(svc[m, bk]), set()).add(m)
        per_chan = self.by_channel()
        out: dict[int, int] = {}
        for ch_ix, nodes in chan_nodes.items():
            ps = int(per_chan[ch_ix]) if ch_ix < self.table.shape[0] - 1 else 0
            for node in nodes:
                out[node] = out.get(node, 0) + ps
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def blame(bp: Backpointers, rows=None, paths=None) -> Blame:
    """Aggregate per-request critical paths into a `Blame` table.

    Asserts the conservation invariant per request: edge contributions sum
    exactly to ``complete − issue``.
    """
    if rows is None:
        rows = list(range(bp.n))
    else:
        rows = [int(r) for r in rows]
    if paths is None:
        paths = [critical_path(bp, r) for r in rows]
    table = np.zeros((bp.c + 1, N_KINDS), np.int64)
    total = 0
    for r, path in zip(rows, paths):
        want = int(bp.complete[r]) - int(bp.issue[r])
        got = path_total(path)
        if got != want:
            raise AssertionError(
                f"conservation violated for row {r}: path sums to {got} ps, "
                f"complete - issue = {want} ps")
        total += want
        for e in path:
            ch_ix = e.channel if e.channel >= 0 else bp.c
            table[ch_ix, e.kind] += e.ps
    return Blame(table, len(rows), total)


def speedup_if(bp: Backpointers, channel: int, factor: float) -> dict:
    """Coz-style what-if: completion times if ``channel`` were ``factor``×
    faster, re-propagated along the frozen backpointer DAG.

    Serialization on the target channel scales to ``wire // factor``; every
    other edge weight (turnaround gaps, retrain intervals, row penalties,
    fixed latencies) and every backpointer is kept frozen, and event times
    are recomputed as ``max`` over each event's recorded parents (own
    arrival always remains a floor, so estimates stay causally sane).  This
    is a first-order estimate (contention is not re-resolved, FCFS order
    never changes), exact for ``factor == 1`` and monotone for speedups
    along the frozen DAG.
    """
    n, h = bp.n, bp.h
    on_chan = bp.serving & (bp.channel == channel)
    new_wire = np.where(on_chan,
                        (bp.wire.astype(np.float64) / factor).astype(np.int64),
                        bp.wire).tolist()
    # frozen edge weights, from the baseline schedule
    q_gap = (bp.start - np.where(
        bp.bind == B_QUEUE, bp.depart[bp.qpred_row, bp.qpred_hop],
        bp.start)).tolist()
    r_gap = (bp.start - np.where(
        bp.bind == B_RETRAIN, bp.depart[bp.rsrc_row, bp.rsrc_hop],
        bp.start)).tolist()
    L = bp._py_lists()
    issue, gate_row, valid, serving = (L["issue"], L["gate_row"], L["valid"],
                                       L["serving"])
    fixed, row_extra, bind = L["fixed"], L["row_extra"], L["bind"]

    A = [[-1] * (h + 1) for _ in range(n)]
    S = [[-1] * h for _ in range(n)]
    D = [[-1] * h for _ in range(n)]

    stack = [("A", r, h) for r in range(n)]
    budget = 64 * (n * (2 * h + 1) + 8)
    while stack:
        budget -= 1
        if budget < 0:
            raise RuntimeError("speedup_if propagation did not terminate "
                               "(cyclic backpointers?)")
        tag, p, j = stack[-1]
        if tag == "A":
            if A[p][j] >= 0:
                stack.pop()
                continue
            if j == 0:
                g = gate_row[p]
                if g >= 0:
                    if A[g][h] < 0:
                        stack.append(("A", g, h))
                        continue
                    A[p][0] = max(issue[p], A[g][h])
                else:
                    A[p][0] = issue[p]
            elif valid[p][j - 1]:
                if D[p][j - 1] < 0:
                    stack.append(("D", p, j - 1))
                    continue
                A[p][j] = D[p][j - 1] + fixed[p][j - 1]
            else:
                if A[p][j - 1] < 0:
                    stack.append(("A", p, j - 1))
                    continue
                A[p][j] = A[p][j - 1]
            stack.pop()
        elif tag == "D":
            if D[p][j] >= 0:
                stack.pop()
                continue
            if not serving[p][j]:
                if A[p][j] < 0:
                    stack.append(("A", p, j))
                    continue
                D[p][j] = A[p][j]
            else:
                if S[p][j] < 0:
                    stack.append(("S", p, j))
                    continue
                D[p][j] = S[p][j] + new_wire[p][j] + row_extra[p][j]
            stack.pop()
        else:  # "S"
            if S[p][j] >= 0:
                stack.pop()
                continue
            if A[p][j] < 0:
                stack.append(("A", p, j))
                continue
            b = bind[p][j]
            if b == B_QUEUE:
                pr, pj = L["qpred_row"][p][j], L["qpred_hop"][p][j]
                if D[pr][pj] < 0:
                    stack.append(("D", pr, pj))
                    continue
                S[p][j] = max(A[p][j], D[pr][pj] + q_gap[p][j])
            elif b == B_RETRAIN:
                sr, sj = L["rsrc_row"][p][j], L["rsrc_hop"][p][j]
                if D[sr][sj] < 0:
                    stack.append(("D", sr, sj))
                    continue
                S[p][j] = max(A[p][j], D[sr][sj] + r_gap[p][j])
            else:
                S[p][j] = A[p][j]
            stack.pop()

    new_complete = np.asarray([a[h] for a in A], np.int64)
    base = bp.complete
    lat_new = new_complete - bp.issue
    lat_old = base - bp.issue
    nreq = max(n, 1)
    return {
        "channel": int(channel),
        "factor": float(factor),
        "complete_ps": new_complete,
        "baseline_complete_ps": base,
        "latency_delta_ps": lat_new - lat_old,
        "mean_latency_ps": int(lat_new.sum()) // nreq,
        "baseline_mean_latency_ps": int(lat_old.sum()) // nreq,
        "saved_ps": int((lat_old - lat_new).sum()),
    }
