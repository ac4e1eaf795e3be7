"""Chrome-trace-event export: Perfetto-loadable timelines from schedules,
PyTorch port.

The counterpart of ``repro.core.trace_export``, function for function; the
trace dict it builds for a schedule equals the reference's event for event
and in the same order.  It renders a resolved `(Hops, Channels, Schedule)`
triple, and optionally a `CoupledResult`'s convergence history, to the
Chrome trace event format (the JSON Perfetto and ``chrome://tracing`` load
natively):

  * one thread track per fabric channel (pid 0, tid = channel index),
    hop transmissions as "B"/"E" duration pairs: FCFS grants never
    overlap on a channel, so the pairs nest trivially;
  * per-channel *link-down* tracks (tid = C + channel) with merged
    retraining intervals as duration pairs, plus an "i" instant at each
    retrain trigger;
  * fixpoint convergence as a "C" counter series on pid 1 (`ts` =
    iteration index): `Schedule.rounds` and, for coupled runs,
    `simulate_coupled`'s per-iteration max-abs residual;
  * optionally (``flows=`` a `critical_path.Backpointers`) the gating
    structure as Chrome flow events (cat ``critical_path``): one "s"/"f"
    arrow per cross-row QUEUE grant (FCFS predecessor's depart -> grant),
    per cross-row RETRAIN release (down-window source -> grant, drawn
    from the link-down track) and per binding JOIN contributor (slowest
    fork leg's last transmission -> waiter's first grant);
  * optionally (``blame=`` a `critical_path.Blame`) the aggregated blame
    tables as a "C" counter series on pid 2 (`ts` = channel index).

Everything here runs on the host over the tables and schedule it is given,
tensors on any device, each field pulled once (`engine.to_host`, no
per-event device sync), and never feeds back into simulation: the exporter
is an observer of finished schedules, exactly like `core.telemetry`.
`validate_trace` is the schema gate: valid JSON, monotone ``ts``, matched
B/E pairs per track, well-formed flows.

Timestamps: the trace format's native unit is microseconds; events are
emitted in integer **nanoseconds** with ``displayTimeUnit: "ns"`` so
sub-ns picosecond detail rounds (ps % 1000) only at display, never
reorders (monotonicity is preserved under the floor because event order
is sorted on the ns values themselves).
"""

from __future__ import annotations

import json

import numpy as np

from .critical_path import B_QUEUE, B_RETRAIN, KIND_NAMES
from .engine import Channels, Hops, Schedule, make_channels, to_host
from .topology import MEMORY, REQUESTER, FabricGraph

_KIND = {REQUESTER: "req", MEMORY: "mem"}


def channel_names(graph: FabricGraph) -> list[str]:
    """Human-readable per-channel track names for a built fabric graph:
    directed link channels as ``u->v`` / ``u<->v`` (half-duplex) with node
    kinds, service channels as ``mem m bank k``."""
    names = [""] * graph.n_channels

    def node(i: int) -> str:
        return f"{_KIND.get(int(graph.topo.kinds[i]), 'sw')}{i}"

    for (u, v), (c, d) in sorted(graph._edge.items()):
        if d == 0 and not names[c]:
            arrow = "<->" if int(graph.chan_pair[c]) < 0 else "->"
            names[c] = f"{node(u)} {arrow} {node(v)}"
    for m in range(graph._service_chan.shape[0]):
        for bk in range(graph._service_chan.shape[1]):
            c = int(graph._service_chan[m, bk])
            if c >= 0:
                names[c] = f"{node(m)} bank{bk}"
    for c, n in enumerate(names):
        if not n:
            names[c] = f"chan{c}"
    return names


def _merge_intervals(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merge overlapping/touching [lo, hi) intervals (sorted output)."""
    out: list[tuple[int, int]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _flow_events(bp, c: int, ns) -> list[dict]:
    """Flow "s"/"f" arrows (cat ``critical_path``) for the cross-row gating
    edges recorded in a `critical_path.Backpointers`: QUEUE grants chained
    from another row's depart, RETRAIN grants chained from the down-window
    source (drawn off the link-down track, tid ``c + channel``), and the
    binding JOIN contributor per gated row."""
    evs: list[dict] = []
    fid = 0

    def arrow(name, s_tid, s_ts, f_tid, f_ts):
        nonlocal fid
        evs.append({"ph": "s", "pid": 0, "tid": s_tid, "ts": ns(s_ts),
                    "cat": "critical_path", "name": name, "id": fid})
        evs.append({"ph": "f", "bp": "e", "pid": 0, "tid": f_tid,
                    "ts": ns(f_ts), "cat": "critical_path", "name": name,
                    "id": fid})
        fid += 1

    last_occ = np.where(bp.serving.any(axis=1),
                        bp.serving.shape[1] - 1
                        - bp.serving[:, ::-1].argmax(axis=1), -1)
    first_occ = np.where(bp.serving.any(axis=1),
                         bp.serving.argmax(axis=1), -1)
    for r, j in zip(*np.nonzero(bp.valid)):
        ci = int(bp.channel[r, j])
        if bp.bind[r, j] == B_QUEUE:
            p, i = int(bp.qpred_row[r, j]), int(bp.qpred_hop[r, j])
            if p != r:
                arrow("queue", int(bp.channel[p, i]), bp.depart[p, i],
                      ci, bp.start[r, j])
        elif bp.bind[r, j] == B_RETRAIN:
            p, i = int(bp.rsrc_row[r, j]), int(bp.rsrc_hop[r, j])
            if p != r:
                # the down window lives on the grant's own channel; its
                # source is by construction a same-channel item/marker
                arrow("retrain", c + ci, bp.depart[p, i],
                      ci, bp.start[r, j])
    for r in range(bp.n):
        g = int(bp.gate_row[r])
        if g >= 0 and g != r and last_occ[g] >= 0 and first_occ[r] >= 0:
            gj, rj = int(last_occ[g]), int(first_occ[r])
            arrow("join", int(bp.channel[g, gj]), bp.depart[g, gj],
                  int(bp.channel[r, rj]), bp.start[r, rj])
    return evs


def schedule_trace(hops: Hops, channels: Channels, sched: Schedule,
                   names: list[str] | None = None,
                   residual_ps=None, flows=None, blame=None) -> dict:
    """Render one schedule as a Chrome-trace-event dict (see module doc).

    ``names`` labels the channel tracks (`channel_names(graph)`);
    ``residual_ps`` (optional, from `CoupledResult.residual_ps`) adds the
    coupled-fixpoint residual counter series; ``flows`` (optional, a
    `critical_path.Backpointers` for this schedule) adds the gating-edge
    flow arrows; ``blame`` (optional, a `critical_path.Blame`) adds the
    pid-2 blame counter series.
    """
    c = int(channels.bw_MBps.shape[0])
    chan = to_host(hops.channel)
    nbytes = to_host(hops.nbytes)
    valid = to_host(hops.valid)
    start = to_host(sched.start)
    depart = to_host(sched.depart)
    arrive = to_host(sched.arrive)
    retrain = (to_host(hops.retrain_after_ps)
               if hops.retrain_after_ps is not None else None)
    names = names or [f"chan{i}" for i in range(c)]

    def ns(ps: int) -> int:
        return int(ps) // 1000

    events: list[dict] = []
    meta: list[dict] = []
    meta.append({"ph": "M", "pid": 0, "name": "process_name",
                 "args": {"name": "fabric channels"}})
    meta.append({"ph": "M", "pid": 1, "name": "process_name",
                 "args": {"name": "fixpoint convergence"}})
    have_down = retrain is not None and bool(np.any(retrain[valid] > 0))
    for i in range(c):
        label = names[i] if i < len(names) else f"chan{i}"
        meta.append({"ph": "M", "pid": 0, "tid": i, "name": "thread_name",
                     "args": {"name": label}})
        if have_down:
            meta.append({"ph": "M", "pid": 0, "tid": c + i,
                         "name": "thread_name",
                         "args": {"name": f"{label} [link down]"}})

    occupied = valid & (nbytes > 0)
    tx_spans: list[list[tuple]] = [[] for _ in range(c)]
    down_spans: list[list[tuple[int, int]]] = [[] for _ in range(c)]
    for p, hop in zip(*np.nonzero(valid)):
        ci = int(chan[p, hop])
        if ci < 0 or ci >= c:
            continue
        t0, t1 = int(start[p, hop]), int(depart[p, hop])
        if occupied[p, hop]:
            tx_spans[ci].append((t0, t1, int(p), int(hop),
                                 int(nbytes[p, hop]),
                                 t0 - int(arrive[p, hop])))
        if retrain is not None and int(retrain[p, hop]) > 0:
            # transmissions trigger the down window at depart; zero-byte
            # retrain markers carry it at their arrival instant
            at = t1 if occupied[p, hop] else int(arrive[p, hop])
            down_spans[ci].append((at, at + int(retrain[p, hop])))
            events.append({"ph": "i", "pid": 0, "tid": ci, "ts": ns(at),
                           "name": "retrain", "s": "t"})
    # FCFS serializes each channel's grants, so spans sorted by start are
    # disjoint; emitting B,E consecutively per track keeps every track's
    # file order balanced through the stable global ts sort below (events
    # with equal ts never reorder within a track).
    for ci in range(c):
        for t0, t1, p, hop, nb, wait in sorted(tx_spans[ci]):
            events.append({"ph": "B", "pid": 0, "tid": ci, "ts": ns(t0),
                           "name": f"req{p}.h{hop}",
                           "args": {"bytes": nb, "wait_ps": wait}})
            events.append({"ph": "E", "pid": 0, "tid": ci, "ts": ns(t1)})
        for lo, hi in _merge_intervals(down_spans[ci]):
            events.append({"ph": "B", "pid": 0, "tid": c + ci, "ts": ns(lo),
                           "name": "retraining"})
            events.append({"ph": "E", "pid": 0, "tid": c + ci, "ts": ns(hi)})

    if flows is not None:
        # appended after the B/E spans so equal-ts flow endpoints sort
        # after their enclosing slice boundaries (stable sort below)
        events.extend(_flow_events(flows, c, ns))
    if blame is not None:
        meta.append({"ph": "M", "pid": 2, "name": "process_name",
                     "args": {"name": "bottleneck blame"}})
        meta.append({"ph": "M", "pid": 2, "tid": 0, "name": "thread_name",
                     "args": {"name": "blame (ps)"}})
        for ci in range(c):
            label = names[ci] if ci < len(names) else f"chan{ci}"
            events.append({
                "ph": "C", "pid": 2, "tid": 0, "ts": ci,
                "name": f"blame {label}",
                "args": {KIND_NAMES[k]: int(blame.table[ci, k])
                         for k in range(blame.table.shape[1])
                         if int(blame.table[ci, k])}})
        events.append({"ph": "C", "pid": 2, "tid": 0, "ts": c,
                       "name": "blame total",
                       "args": {k: int(v)
                                for k, v in blame.by_kind().items() if v}})

    events.append({"ph": "C", "pid": 1, "tid": 0, "ts": 0,
                   "name": "engine rounds",
                   "args": {"rounds": int(to_host(sched.rounds))}})
    if residual_ps is not None:
        for it, r in enumerate(to_host(residual_ps).reshape(-1)):
            events.append({"ph": "C", "pid": 1, "tid": 0, "ts": it + 1,
                           "name": "coupled residual",
                           "args": {"residual_ps": int(r)}})

    events.sort(key=lambda e: e["ts"])  # stable: per-track order survives
    return {"traceEvents": meta + events, "displayTimeUnit": "ns"}


def coupled_trace(result, graph: FabricGraph) -> dict:
    """Trace a `CoupledResult`: final-iteration schedule (coherence rows
    plus any background rows) on named channel tracks + the coupled-
    fixpoint residual counter series (channel tables on the schedule's
    device)."""
    channels = make_channels(graph, device=result.schedule.arrive.device)
    hops = (result.fabric_hops if result.fabric_hops is not None
            else result.lowering.hops)
    return schedule_trace(hops, channels, result.schedule,
                          names=channel_names(graph),
                          residual_ps=result.residual_ps)


def write_trace(trace: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(trace, f, separators=(",", ":"))
    return path


def validate_trace(obj) -> list[str]:
    """Schema gate (CI): returns a list of violations, empty when clean.

    Checks: top-level shape, required event fields, non-negative integer
    ``ts`` monotone in file order (per the format's requirement for
    same-track nesting we check globally — the exporter sorts), matched,
    properly nested B/E pairs per (pid, tid) track, and well-formed flow
    sequences per (cat, id): every "s" unique, every "t"/"f" preceded by
    its "s", no flow left dangling at end of file.
    """
    errs: list[str] = []
    if isinstance(obj, (str, bytes)):
        try:
            obj = json.loads(obj)
        except json.JSONDecodeError as e:
            return [f"invalid JSON: {e}"]
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing traceEvents object"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    last_ts = None
    stacks: dict[tuple, int] = {}
    flows_open: set[tuple] = set()
    for i, e in enumerate(evs):
        if not isinstance(e, dict) or "ph" not in e:
            errs.append(f"event {i}: not an event object")
            continue
        ph = e["ph"]
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, int) or ts < 0:
            errs.append(f"event {i}: bad ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            errs.append(f"event {i}: ts {ts} < previous {last_ts}")
        last_ts = ts
        key = (e.get("pid"), e.get("tid"))
        if ph == "B":
            if "name" not in e:
                errs.append(f"event {i}: B without name")
            stacks[key] = stacks.get(key, 0) + 1
        elif ph == "E":
            if stacks.get(key, 0) <= 0:
                errs.append(f"event {i}: E without matching B on {key}")
            else:
                stacks[key] -= 1
        elif ph in ("s", "t", "f"):
            if "name" not in e:
                errs.append(f"event {i}: flow {ph} without name")
            if "id" not in e:
                errs.append(f"event {i}: flow {ph} without id")
                continue
            fkey = (e.get("cat"), e["id"])
            if ph == "s":
                if fkey in flows_open:
                    errs.append(f"event {i}: duplicate flow s for {fkey}")
                flows_open.add(fkey)
            elif fkey not in flows_open:
                errs.append(f"event {i}: flow {ph} without open s "
                            f"for {fkey}")
            elif ph == "f":
                flows_open.discard(fkey)
    for key, depth in stacks.items():
        if depth:
            errs.append(f"track {key}: {depth} unclosed B event(s)")
    for fkey in sorted(flows_open, key=repr):
        errs.append(f"flow {fkey}: no terminating f event")
    return errs
