"""Fabric-coupled device coherence: BISnp/BIRsp/InvBlk as fabric traffic,
PyTorch port.

The counterpart of ``repro.core.coherence_traffic``.  The snoop filter
(`core.snoop_filter`) runs the DCOH protocol against an analytic, isolated
timing model; this module closes the loop against the exact FCFS engine:

  * **Event lowering** (`lower_coherence`, host numpy like
    `devices.build_workload`, tables to the device at the end): the scan's
    per-request `SFEvents` log becomes hop rows on a `FabricGraph`.
    ``fanout="concurrent"`` (default) forks k BISnp rows for a miss with k
    owners and joins the demand leg on the slowest BIRsp (the engine's
    fork/join primitive); write conflicts on local-cache hits lower as
    upgrade-BISnp fork groups.  ``fanout="chain"`` is the serialized model:
    one hop chain per request, owners snooped one after another.
  * **Outer fixpoint** (`coupled_fixpoint`, for several members at once;
    `simulate_coupled` is its one-member case): run the SF scan with the
    current per-request stall times, schedule the lowered rows with any
    background demand, feed each miss's measured round trip back, until it
    stops moving.  Decisions depend only on stream order, so the lowering
    happens once; only issue times and latencies iterate.  ``damping``
    (`engine.SimOptions`) averages the last two latency vectors.

Every table equals the reference's; every schedule goes through the port's
engine (the fused serve-round kernel on the card) and every SF scan through
`kernels.sf_scan`.  `hop_legs` / `leg_blame` map a lowering's hops to
protocol legs for the critical-path view (`core.critical_path`).
`CoherenceStream` feeds the streaming engine (`core.streaming.
simulate_stream`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import link_layer
from .devices import Workload, finish_hops, marker_column_map, packetize
from .engine import (Hops, Schedule, SimOptions, make_channels, member,
                     round_bound, settle, simulate_stacked, stack_members,
                     to_host)
from .snoop_filter import (CacheConfig, SFConfig, SFEvents, SFResult,
                           sf_init_state, simulate_sf, simulate_sf_many)
from .topology import SWITCH, FabricGraph

FANOUT_MODES = ("concurrent", "chain")


@dataclass(frozen=True)
class CoherenceFabricSpec:
    """Placement of the DCOH protocol onto a fabric.

    dev_node      the device (MEMORY node) whose HDM the stream targets —
                  it owns the SF and initiates BISnp traffic.
    req_nodes     fabric node of each requester id (REQUESTER nodes).
    header_bytes  BISnp/BIRsp/demand-header packet size.
    max_snoop     snoop legs lowered per request; owners beyond it are
                  dropped from the hop table (0 = all requesters).
    """

    dev_node: int
    req_nodes: tuple[int, ...]
    header_bytes: int = 16
    max_snoop: int = 0

    def n_snoop(self) -> int:
        return self.max_snoop if self.max_snoop > 0 else len(self.req_nodes)


class CoherenceLowering(NamedTuple):
    """Hop tables of one event log, and the maps to read the schedule back.

    Chain layout: one row per request; the ``*_cols`` fields index the
    logical (pre-marker) layout and ``col_map[j, i]`` gives the physical
    column of logical column ``i`` of row ``j``.  Concurrent layout: the
    first T rows are the requests' primary rows, then the fork rows;
    ``row_req`` maps every row to its request and ``snoop_rows[j, k]`` is
    the row of request ``j``'s k-th BISnp round trip (-1 unused).  The
    numpy fields stay on the host; ``hops`` is on the lowering's device."""

    hops: Hops
    miss: np.ndarray          # (T,) bool — demand rows with fabric traffic
    fwd_cols: int             # demand request hops span [0, fwd_cols)
    snoop_cols: int           # per-leg hop span
    n_snoop: int              # snoop slots per request
    svc_col: int              # endpoint service hop column (logical)
    col_map: np.ndarray       # (T, logical H) -> physical column
    n_cols: int               # total physical hop columns (markers included)
    fanout: str = "chain"
    row_req: np.ndarray | None = None     # (N,) request index of each row
    snoop_rows: np.ndarray | None = None  # (T, n_snoop) BISnp row index


class CoupledResult(NamedTuple):
    sf: SFResult              # SF view under fabric-measured stall times
    events: SFEvents          # protocol decisions (fixpoint invariant)
    schedule: Schedule        # fabric schedule of the final iteration
    lowering: CoherenceLowering
    fabric_lat_ps: torch.Tensor   # (T,) measured miss round trips
    bisnp_lat_ps: torch.Tensor    # (T, n_snoop) per-BISnp round trips
    issue_ps: torch.Tensor        # (T,) fabric issue times of the final pass
    iters: int
    converged: bool
    used_oracle: bool
    damped: int = 0              # averaged (damped) updates applied
    rounds: int = 0              # total engine rounds across all iterations
    residual_ps: "np.ndarray | None" = None  # per-iteration max |Δfabric_lat|
    fabric_hops: "Hops | None" = None       # the final pass's engine view
    fabric_issue_ps: "torch.Tensor | None" = None


def _route_chans(graph: FabricGraph, src: int, dst: int):
    """[(channel, direction, fixed_after)] of the default route src -> dst."""
    path = graph.route(src, dst)
    sw_ps = graph.topo.switching_ps
    out = []
    for u, v in zip(path[:-1], path[1:]):
        c, d = graph.edge_channel(u, v)
        fixed = int(graph.chan_fixed_ps[c]) + (
            sw_ps if graph.topo.kinds[v] == SWITCH else 0)
        out.append((c, d, fixed))
    return out


def _owner_bits(mask: int, n_req: int, k: int) -> list[int]:
    """First ``k`` requester indices set in a BISnp owner bitmask, scanned
    over the requester count only (a mask with bit 31 set is negative)."""
    return [b for b in range(n_req) if (mask >> b) & 1][:k]


class _RowBuilder:
    """Growable (rows x H) hop tables, filled leg by leg, shared by both
    lowerings."""

    def __init__(self, n_rows: int, h: int):
        self.h = h
        self.chan = np.full((n_rows, h), -1, np.int32)
        self.nbytes = np.zeros((n_rows, h), np.int64)
        self.direction = np.zeros((n_rows, h), np.int8)
        self.row_id = np.full((n_rows, h), -1, np.int32)
        self.fixed_after = np.zeros((n_rows, h), np.int64)
        self.is_payload = np.zeros((n_rows, h), bool)
        self.valid = np.zeros((n_rows, h), bool)

    def fill_leg(self, j, k0, leg, nb, payload_flag):
        for i, (c, d, fx) in enumerate(leg):
            self.chan[j, k0 + i] = c
            self.nbytes[j, k0 + i] = nb
            self.direction[j, k0 + i] = d
            self.fixed_after[j, k0 + i] = fx
            self.is_payload[j, k0 + i] = payload_flag
            self.valid[j, k0 + i] = True
        return k0 + len(leg)

    def service_hop(self, j, col, graph, spec, sf_cfg, a):
        ep = graph.topo.endpoint
        bank = a % ep.banks
        self.chan[j, col] = graph.service_channel(spec.dev_node, bank)
        self.nbytes[j, col] = sf_cfg.line_bytes
        self.row_id[j, col] = (a // ep.lines_per_row) % (1 << 30)
        self.fixed_after[j, col] = ep.fixed_ps
        self.is_payload[j, col] = True
        self.valid[j, col] = True


def lower_coherence(graph: FabricGraph, spec: CoherenceFabricSpec,
                    sf_cfg: SFConfig, addr, is_write, rid,
                    events: SFEvents, fanout: str = "concurrent",
                    upgrade_bisnp: bool | None = None,
                    device=None) -> CoherenceLowering:
    """Lower a protocol event log onto the fabric as per-request hop rows
    (the reference's `lower_coherence`, table for table).

    ``fanout="concurrent"`` (default): misses with k snooped owners fork k
    concurrent BISnp rows gated on the demand request's arrival at the
    device and join the demand leg on the slowest BIRsp; write-conflict
    BISnps on local-cache hits (``upgrade_bisnp``, default on in this mode)
    lower as BISnp-only fork groups.  ``fanout="chain"``: one hop chain per
    request in protocol order

        [demand request] [BISnp out | BIRsp back] * n_snoop [service] [response]

    with upgrade-BISnps left off the fabric.  Stochastic link reliability
    samples per-hop tables and mirrors retraining stalls as
    `devices.build_workload` does.  The tables go to ``device`` (by default
    the device of the events)."""
    if fanout not in FANOUT_MODES:
        raise ValueError(f"unknown fanout {fanout!r}")
    if upgrade_bisnp is None:
        upgrade_bisnp = fanout == "concurrent"
    if upgrade_bisnp and fanout == "chain":
        raise ValueError("upgrade-BISnp lowering needs fanout='concurrent' "
                         "(the chain layout is the serialized one)")
    if device is None:
        device = (events.cache_hit.device
                  if isinstance(events.cache_hit, torch.Tensor) else "cuda")
    addr = to_host(addr)
    is_write = to_host(is_write).astype(bool)
    rid = to_host(rid)
    hit = to_host(events.cache_hit)
    conflict = to_host(events.conflict)
    mask = to_host(events.bisnp_mask)
    wb = to_host(events.wb_lines)
    blk = to_host(events.invblk_len)
    T = int(hit.shape[0])
    K = spec.n_snoop()
    hdr = spec.header_bytes
    line = sf_cfg.line_bytes

    to_dev = [_route_chans(graph, rq, spec.dev_node) for rq in spec.req_nodes]
    to_req = [_route_chans(graph, spec.dev_node, rq) for rq in spec.req_nodes]
    # one span width for every leg: forward and reverse routes may pick
    # different equal-cost paths
    Fmax = Smax = max(max(len(p) for p in to_dev),
                      max(len(p) for p in to_req))

    if fanout == "chain":
        b = _chain_rows(graph, spec, sf_cfg, addr, is_write, rid,
                        hit, mask, wb, blk, T, K, Fmax, Smax, hdr, line,
                        to_dev, to_req)
        svc = Fmax + 2 * K * Smax
        hops = finish_hops(graph, link_layer.normalize(None), b.chan,
                           b.nbytes, b.direction, b.row_id, b.fixed_after,
                           b.is_payload, b.valid, stream_salt=0x636F68,
                           device=device)
        return CoherenceLowering(
            hops=hops, miss=~hit, fwd_cols=Fmax, snoop_cols=Smax, n_snoop=K,
            svc_col=svc, col_map=marker_column_map(hops),
            n_cols=int(hops.channel.shape[1]), fanout="chain",
            row_req=np.arange(T, dtype=np.int64), snoop_rows=None,
        )

    # ---- concurrent fan-out ------------------------------------------------
    # each snooped miss adds a request-leg (fork) row + k BISnp rows; each
    # upgrade conflict adds its k BISnp rows; primary rows keep the request
    # index
    owners_of = [_owner_bits(int(mask[j]), len(spec.req_nodes), K)
                 for j in range(T)]
    n_extra = 0
    for j in range(T):
        if hit[j]:
            if upgrade_bisnp and conflict[j]:
                n_extra += len(owners_of[j])
        elif owners_of[j]:
            n_extra += 1 + len(owners_of[j])
    svc = Fmax                       # service col on every demand row
    H = 2 * Fmax + 1                 # [request] [service] [response]
    N = T + n_extra
    b = _RowBuilder(N, H)
    join_id = np.full(N, -1, np.int32)
    join_wait = np.full(N, -1, np.int32)
    join_arity = np.zeros(N, np.int32)
    row_req = np.concatenate(
        [np.arange(T, dtype=np.int64), np.zeros(n_extra, np.int64)])
    snoop_rows = np.full((T, K), -1, np.int64)
    nxt_row = T
    nxt_grp = 0

    def snoop_row(j, k, o, with_payload):
        """One BISnp round trip: device->owner out leg (+ the owner's cache
        probe), owner->device BIRsp back (the first slot carries the
        writebacks and the InvBlk response-assembly serialization)."""
        nonlocal nxt_row
        rrow = nxt_row
        nxt_row += 1
        row_req[rrow] = j
        end = b.fill_leg(rrow, 0, to_req[o], hdr, False)          # BISnp out
        b.fixed_after[rrow, end - 1] += sf_cfg.t_cache_ps         # owner probe
        back_b = hdr + (int(wb[j]) * line if with_payload else 0)
        end = b.fill_leg(rrow, Smax, to_dev[o], back_b,
                         with_payload and int(wb[j]) > 0)         # BIRsp back
        if with_payload:
            extra = max(int(blk[j]) - 1, 0)
            b.fixed_after[rrow, end - 1] += (extra * sf_cfg.t_cache_ps
                                             + extra * extra
                                             * sf_cfg.probe_conflict_ps)
        snoop_rows[j, k] = rrow
        return rrow

    for j in range(T):
        owners = owners_of[j]
        if hit[j]:
            # upgrade-BISnp: reverse traffic with no demand leg; the hit's
            # own latency is untouched
            if upgrade_bisnp and conflict[j]:
                for k, o in enumerate(owners):
                    snoop_row(j, k, o, with_payload=False)
            continue
        r = int(rid[j])
        fwd_b, bwd_b, fwd_pay, bwd_pay = packetize(
            "esf", bool(is_write[j]), line, hdr)
        if not owners:               # snoop-free miss: plain chain row
            b.fill_leg(j, 0, to_dev[r], fwd_b, fwd_pay)
        else:
            # fork: the request leg completes at the device and releases the
            # k BISnp rows; the demand leg joins on the slowest BIRsp
            g_req, g_rsp = nxt_grp, nxt_grp + 1
            nxt_grp += 2
            arow = nxt_row
            nxt_row += 1
            row_req[arow] = j
            b.fill_leg(arow, 0, to_dev[r], fwd_b, fwd_pay)
            join_id[arow] = g_req
            for k, o in enumerate(owners):
                rrow = snoop_row(j, k, o, with_payload=k == 0)
                join_wait[rrow] = g_req
                join_arity[rrow] = 1
                join_id[rrow] = g_rsp
            join_wait[j] = g_rsp
            join_arity[j] = len(owners)
        b.service_hop(j, svc, graph, spec, sf_cfg, int(addr[j]))
        b.fill_leg(j, svc + 1, to_req[r], bwd_b, bwd_pay)

    hops = finish_hops(graph, link_layer.normalize(None), b.chan, b.nbytes,
                       b.direction, b.row_id, b.fixed_after, b.is_payload,
                       b.valid, stream_salt=0x636F68,
                       join_id=join_id, join_wait=join_wait,
                       join_arity=join_arity, device=device)
    return CoherenceLowering(
        hops=hops, miss=~hit, fwd_cols=Fmax, snoop_cols=Smax, n_snoop=K,
        svc_col=svc, col_map=marker_column_map(hops),
        n_cols=int(hops.channel.shape[1]), fanout="concurrent",
        row_req=row_req, snoop_rows=snoop_rows,
    )


def _chain_rows(graph, spec, sf_cfg, addr, is_write, rid, hit, mask, wb, blk,
                T, K, Fmax, Smax, hdr, line, to_dev, to_req) -> _RowBuilder:
    """The serialized row layout (fixed shape; unused spans are invalid
    pass-through hops):

        [demand request] [BISnp out | BIRsp back] * n_snoop [service] [response]

    Only cache misses lower to fabric traffic here."""
    svc = Fmax + 2 * K * Smax
    H = svc + 1 + Fmax
    b = _RowBuilder(T, H)
    for j in range(T):
        if hit[j]:
            continue                       # hits never reach the fabric
        r = int(rid[j])
        fwd_b, bwd_b, fwd_pay, bwd_pay = packetize(
            "esf", bool(is_write[j]), line, hdr)
        b.fill_leg(j, 0, to_dev[r], fwd_b, fwd_pay)
        owners = _owner_bits(int(mask[j]), len(spec.req_nodes), K)
        for k, o in enumerate(owners):
            k0 = Fmax + 2 * k * Smax
            end = b.fill_leg(j, k0, to_req[o], hdr, False)        # BISnp out
            b.fixed_after[j, end - 1] += sf_cfg.t_cache_ps        # owner probe
            back_b = hdr + (int(wb[j]) * line if k == 0 else 0)
            end = b.fill_leg(j, k0 + Smax, to_dev[o], back_b,
                             k == 0 and int(wb[j]) > 0)           # BIRsp back
            if k == 0:
                extra = max(int(blk[j]) - 1, 0)
                b.fixed_after[j, end - 1] += (extra * sf_cfg.t_cache_ps
                                              + extra * extra
                                              * sf_cfg.probe_conflict_ps)
        b.service_hop(j, svc, graph, spec, sf_cfg, int(addr[j]))
        b.fill_leg(j, svc + 1, to_req[r], bwd_b, bwd_pay)
    return b


def bisnp_latencies(sched: Schedule, low: CoherenceLowering) -> torch.Tensor:
    """Per-request, per-slot BISnp round trips (0 for unused slots).

    Concurrent layout: row completion minus the row's post-join issue
    (``arrive[:, 0]``).  Chain layout: arrival after the BIRsp leg minus
    arrival at the BISnp leg, read through ``col_map`` (the one-past-the-end
    logical column maps to the physical end column)."""
    dev = sched.complete.device
    if low.snoop_rows is not None:
        nrow = sched.complete.shape[0]
        rows = torch.from_numpy(
            np.minimum(np.maximum(low.snoop_rows, 0), nrow - 1)).to(dev)
        rt = sched.complete[rows] - sched.arrive[rows, 0]
        return torch.where(torch.from_numpy(low.snoop_rows >= 0).to(dev),
                           rt, 0)
    t = low.col_map.shape[0]
    arrive = sched.arrive[:t]            # background rows ride behind
    cm = np.concatenate(
        [low.col_map, np.full((t, 1), low.n_cols, np.int64)], axis=1)
    outs = []
    for k in range(low.n_snoop):
        k0 = low.fwd_cols + 2 * k * low.snoop_cols
        k1 = k0 + 2 * low.snoop_cols
        a0 = arrive.gather(1, torch.from_numpy(cm[:, [k0]]).to(dev))[:, 0]
        a1 = arrive.gather(1, torch.from_numpy(cm[:, [k1]]).to(dev))[:, 0]
        outs.append(a1 - a0)
    return torch.stack(outs, dim=1)



LEG_DEMAND_REQ, LEG_SERVICE, LEG_DEMAND_RSP, LEG_BISNP, LEG_BIRSP, \
    LEG_WRITEBACK = range(6)
LEG_NAMES = ("demand_req", "service", "demand_rsp", "bisnp", "birsp",
             "writeback")


def hop_legs(low: CoherenceLowering) -> np.ndarray:
    """Protocol-leg code of every physical hop: ``legs[j, k]`` is a
    `LEG_NAMES` index, -1 for invalid hops and retraining markers.

    Spans come from the lowering's logical layout (`fwd_cols` /
    `snoop_cols` / `svc_col`) scattered to physical columns through
    ``col_map``, so marker-shifted rows keep their labels exact.  A
    payload-carrying BIRsp hop is the dirty-line writeback.  Host numpy,
    the hop table pulled once from its device."""
    valid = to_host(low.hops.valid)
    pay = to_host(low.hops.is_payload)
    n_rows = valid.shape[0]
    F, S, svc = low.fwd_cols, low.snoop_cols, low.svc_col
    h_old = low.col_map.shape[1]
    logical = np.full((n_rows, h_old), -1, np.int8)
    if low.fanout == "concurrent":
        t = low.miss.shape[0]
        logical[:, :F] = LEG_DEMAND_REQ      # demand + fork request legs
        logical[:t, svc] = LEG_SERVICE
        logical[:t, svc + 1:] = LEG_DEMAND_RSP
        sr = low.snoop_rows[low.snoop_rows >= 0]
        if sr.size:
            logical[sr, :S] = LEG_BISNP
            logical[sr, S:2 * S] = LEG_BIRSP
            logical[sr, 2 * S:] = -1
    else:
        logical[:, :F] = LEG_DEMAND_REQ
        for k in range(low.n_snoop):
            lo = F + 2 * k * S
            logical[:, lo:lo + S] = LEG_BISNP
            logical[:, lo + S:lo + 2 * S] = LEG_BIRSP
        logical[:, svc] = LEG_SERVICE
        logical[:, svc + 1:] = LEG_DEMAND_RSP
    legs = np.full((n_rows, low.n_cols), -1, np.int8)
    np.put_along_axis(legs, low.col_map, logical, axis=1)
    legs = np.where(valid, legs, -1)
    return np.where((legs == LEG_BIRSP) & pay, LEG_WRITEBACK, legs)


def leg_blame(low: CoherenceLowering, paths) -> dict[str, int]:
    """Critical-path picoseconds per protocol leg.

    ``paths`` is `critical_path.critical_paths` output for the *fabric*
    schedule the lowering ran in (background rows appended after the
    coherence rows are fine).  Each edge bills the leg of its gated item;
    edges on rows past the lowering (background traffic) land in
    ``"background"``; row-level edges (issue, join) and marker hops land
    in ``"protocol"``.  Values sum to the summed path totals."""
    legs = hop_legs(low)
    out = dict.fromkeys(LEG_NAMES + ("protocol", "background"), 0)
    for path in paths:
        for e in path:
            if e.ps == 0:
                continue
            if e.row >= legs.shape[0]:
                out["background"] += e.ps
            elif e.hop >= 0 and legs[e.row, e.hop] >= 0:
                out[LEG_NAMES[int(legs[e.row, e.hop])]] += e.ps
            else:
                out["protocol"] += e.ps
    return out

def coherence_issue(low: CoherenceLowering, fab_issue_ps) -> torch.Tensor:
    """Per-row issue vector of a lowering: fork/BISnp/upgrade rows inherit
    their request's issue clock (``row_req``)."""
    if low.row_req is None:
        return fab_issue_ps
    return fab_issue_ps[torch.from_numpy(low.row_req).to(
        fab_issue_ps.device)]


def pad_rows(hops: Hops, n_rows: int) -> Hops:
    """Pad a hop table with trailing invalid rows (channel -1, no joins) so
    lowerings of different row counts stack for one stacked fabric pass."""
    n, h = hops.channel.shape
    if n_rows < n:
        raise ValueError(f"cannot pad {n} rows down to {n_rows}")
    if n_rows == n:
        return hops
    m = n_rows - n

    def pad(x, fill):
        return torch.cat([x, torch.full((m,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    fills = dict(channel=-1, row=-1, join_id=-1, join_wait=-1)
    return Hops(**{name: None if val is None else pad(val, fills.get(name, 0))
                   for name, val in zip(Hops._fields, hops)})


def concat_background(low: CoherenceLowering, issue_ps,
                      background: "Workload | None"):
    """Stack the coherence rows (first) with a background demand Workload
    built on the same graph, padding hop columns and reliability tables.
    ``issue_ps`` must already cover every coherence row (`coherence_issue`).
    Returns ``(hops, issue)`` for the engine."""
    if background is None:
        return low.hops, issue_ps
    a, b = low.hops, background.hops
    h = max(a.channel.shape[1], b.channel.shape[1])

    def pad(x, fill):
        if x.shape[1] == h:
            return x
        return torch.cat([x, torch.full((x.shape[0], h - x.shape[1]), fill,
                                        dtype=x.dtype, device=x.device)], 1)

    def join(name, fill):
        return torch.cat([pad(getattr(a, name), fill),
                          pad(getattr(b, name), fill)])

    hops = Hops(
        channel=join("channel", -1), nbytes=join("nbytes", 0),
        direction=join("direction", 0), row=join("row", -1),
        fixed_after_ps=join("fixed_after_ps", 0),
        is_payload=join("is_payload", False), valid=join("valid", False),
    )
    if a.extra_wire_bytes is not None or b.extra_wire_bytes is not None:
        def rel(x, name):
            f = getattr(x, name)
            return f if f is not None else torch.zeros_like(
                x.channel, dtype=torch.int64)

        hops = hops._replace(**{
            name: torch.cat([pad(rel(a, name), 0), pad(rel(b, name), 0)])
            for name in ("extra_wire_bytes", "retrain_after_ps")})
    if a.join_id is not None:
        # background rows never wait or contribute; coherence rows stay
        # first, so group ids keep pointing at the same row index space
        nb = b.channel.shape[0]

        def tail(x, fill):
            return torch.cat([x, torch.full((nb,), fill, dtype=torch.int32,
                                            device=x.device)])

        hops = hops._replace(join_id=tail(a.join_id, -1),
                             join_wait=tail(a.join_wait, -1),
                             join_arity=tail(a.join_arity, 0))
    return hops, torch.cat([issue_ps, background.issue_ps])


def _stack_schedules(scheds) -> Schedule:
    """One stacked `Schedule` (as `simulate_stacked` returns) of members."""
    return Schedule(*(torch.stack([getattr(s, f) for s in scheds])
                      for f in ("arrive", "start", "depart", "complete")),
                    rounds=tuple(int(s.rounds) for s in scheds),
                    converged=tuple(bool(s.converged) for s in scheds),
                    residual_ps=tuple(int(s.residual_ps) for s in scheds))


def fabric_pass(tag, hops: Hops, channels, issue_ps,
                options: SimOptions):
    """The coupled fixpoint's fabric pass over stacked members: one
    `engine.simulate_stacked`, then each member that did not converge
    settled from where it stopped (`engine.settle`: run on, or the oracle,
    as ``options.check`` says), as `engine.simulate_auto` settles a run of
    that member alone; "static" verifies every member first.  ``tag`` names
    the pass (unused here).  Returns ``(schedule, used_oracle)``, both per
    member."""
    m = int(hops.channel.shape[0])

    def alone(k):
        return member(hops, k), member(channels, k), issue_ps[k]

    if options.check == "static":
        from . import verify  # host-side checker

        for k in range(m):
            verify.assert_valid(*alone(k),
                                max_rounds=options.max_rounds or None)
    sched = simulate_stacked(hops, channels, issue_ps, options)
    used = [False] * m
    if options.check != "off" and not all(sched.converged):
        parts = [member(sched, k) for k in range(m)]
        for k in range(m):
            if not parts[k].converged:
                parts[k], used[k] = settle(*alone(k), parts[k], options)
        sched = _stack_schedules(parts)
    return sched, tuple(used)


def coupled_fixpoint(scan, first, lows: list[CoherenceLowering],
                     background: "Workload | None", channels,
                     options: SimOptions | None = None, max_iters: int = 8,
                     tol_ps: int = 0, pass_fn=fabric_pass
                     ) -> list[CoupledResult]:
    """The outer fixpoint of the coupled model, for M members at once (the
    victim policies of a sweep; `simulate_coupled` is its one-member case).

    ``first``: each member's isolated ``(SFResult, SFEvents)``, whose event
    log ``lows`` lowers; ``scan(ks, fabs)`` rescans members ``ks`` with
    those stall times and returns their ``(SFResult, SFEvents)``.  Each
    iteration rescans the members still iterating (one `sf_scan` launch on
    the card) and resolves every member's fabric pass at once:
    ``pass_fn(tag, hops, channels, issue_ps, options)`` over the stacked,
    row-padded tables (the background rows, then the padding, after each
    member's own rows, so the ``[:T]`` prefix and the join group ids stay
    put), `fabric_pass` by default.  A member stops at its own convergence
    (``max |lat - lat_prev| <= tol_ps``); the passes the others still need
    give it the same schedule again.  ``options``: ``max_rounds`` (0 = the
    computed bound of the stacked tables, resolved once), ``check`` and
    ``damping`` (``fab <- (fab + measured) // 2`` from the second
    iteration on; pass ``tol_ps >= 1`` with it).  A member not converged at
    ``tol_ps`` 0 gets a final SF + fabric pass, so every reported field
    belongs to one iteration, as in the reference."""
    if max_iters < 1:
        raise ValueError("max_iters must be >= 1")
    opts = options if options is not None else SimOptions()
    m = len(lows)
    res = [r for r, _ in first]
    evs = [e for _, e in first]
    # hop tables are fixpoint invariants: concat, pad and stack them once
    tables = [concat_background(low, coherence_issue(low, ev.fab_issue_ps),
                                background)[0]
              for low, ev in zip(lows, evs)]
    n_rows = max(int(h.channel.shape[0]) for h in tables)
    hops = stack_members([pad_rows(h, n_rows) for h in tables])
    chans = stack_members([channels] * m)
    inner = SimOptions(max_rounds=opts.max_rounds or round_bound(hops),
                       check=opts.check)
    dev = hops.channel.device
    miss = [torch.from_numpy(low.miss).to(dev) for low in lows]
    t_req = int(lows[0].miss.shape[0])

    def issues():
        out = []
        for low, ev in zip(lows, evs):
            full = coherence_issue(low, ev.fab_issue_ps)
            if background is not None:
                full = torch.cat([full, background.issue_ps])
            out.append(torch.cat([full, full.new_zeros(
                n_rows - full.shape[0])]))
        return torch.stack(out)

    fab = [None] * m
    iters, damped, rounds = [0] * m, [0] * m, [0] * m
    converged = [False] * m
    resid = [[] for _ in range(m)]
    last = [None] * m           # (schedule, used_oracle, issue) per member

    def resolve(tag, ks):
        issue = issues()
        sched, used = pass_fn(tag, hops, chans, issue, inner)
        for k in ks:
            rounds[k] += int(sched.rounds[k])
            last[k] = (member(sched, k), bool(used[k]), issue[k])
        return sched, issue

    live = list(range(m))
    for it in range(1, max_iters + 1):
        if it > 1:
            for k, out in zip(live, scan(live, [fab[k] for k in live])):
                res[k], evs[k] = out
        sched, issue = resolve(f"iter{it}", live)
        for k in live:
            iters[k] = it
            new = torch.where(miss[k], sched.complete[k, :t_req]
                              - issue[k, :t_req], 0)
            if fab[k] is not None:
                resid[k].append(int((new - fab[k]).abs().max()))
                if resid[k][-1] <= tol_ps:
                    fab[k] = new
                    converged[k] = True
                    continue
            if opts.damping and fab[k] is not None:
                fab[k] = (fab[k] + new) // 2     # averaged (damped) update
                damped[k] += 1
            else:
                fab[k] = new
        live = [k for k in live if not converged[k]]
        if not live:
            break

    final = [k for k in range(m) if not (converged[k] and tol_ps == 0)]
    if final:
        for k, out in zip(final, scan(final, [fab[k] for k in final])):
            res[k], evs[k] = out
        resolve("final", final)
    out = []
    for k in range(m):
        sched, used, issue = last[k]
        out.append(CoupledResult(
            sf=res[k], events=evs[k], schedule=sched, lowering=lows[k],
            fabric_lat_ps=fab[k], bisnp_lat_ps=bisnp_latencies(sched,
                                                               lows[k]),
            issue_ps=evs[k].fab_issue_ps, iters=iters[k],
            converged=converged[k], used_oracle=used, damped=damped[k],
            rounds=rounds[k],
            residual_ps=np.asarray(resid[k], dtype=np.int64),
            fabric_hops=member(hops, k), fabric_issue_ps=issue))
    return out


def simulate_coupled(addr, is_write, rid, sf_cfg: SFConfig,
                     cache_cfg: CacheConfig, graph: FabricGraph,
                     spec: CoherenceFabricSpec, n_requesters: int = 1,
                     background: "Workload | None" = None,
                     options: SimOptions | None = None,
                     max_iters: int = 8, tol_ps: int = 0,
                     fanout: str = "concurrent",
                     upgrade_bisnp: bool | None = None,
                     device="cuda") -> CoupledResult:
    """Fabric-coupled DCOH simulation (the §V-B/§V-C studies with the
    infinite bus replaced by routed CXL traffic), on ``device``.

    Outer fixpoint (`coupled_fixpoint`, one member): (1) the SF scan with
    the current per-request stall times (the analytic constants seed the
    first pass), (2) the lowered event log co-scheduled with
    ``background`` (`fabric_pass`: the engine, the oracle where a pass
    misses its bound), (3) each miss's measured round trip fed back as its
    stall time, until ``max |lat - lat_prev| <= tol_ps``.  ``options``:
    ``max_rounds``, ``check`` (forwarded to every pass) and ``damping``."""
    dev = torch.device(device)
    channels = make_channels(graph, graph.topo.endpoint.row_hit_extra_ps,
                             graph.topo.endpoint.row_miss_extra_ps,
                             device=dev)

    def scan(ks, fabs):
        return simulate_sf_many([dict(
            addr=addr, is_write=is_write, req_id=rid, sf_cfg=sf_cfg,
            cache_cfg=cache_cfg, n_requesters=n_requesters, fabric_lat_ps=f,
            return_events=True, device=dev) for f in fabs])

    first = scan([0], [None])
    low = lower_coherence(graph, spec, sf_cfg, addr, is_write, rid,
                          first[0][1], fanout=fanout,
                          upgrade_bisnp=upgrade_bisnp, device=dev)
    return coupled_fixpoint(scan, first, [low], background, channels,
                            options, max_iters, tol_ps)[0]


class CoherenceStream:
    """Chunked ``(hops, issue_ps)`` source for `streaming.simulate_stream`
    — the §V-E-scale front end of the coherence machinery (the reference's
    `CoherenceStream`).

    Iterates the request stream ``chunk`` requests at a time; each chunk
    resumes the SF scan from the carried `SFState` (bit-exact with the
    monolithic scan), lowers its event log (`lower_coherence`; join groups
    are chunk-local) and yields ``(hops, issue_ps)`` on ``device``.  Issue
    clocks come from the analytic scan: no fabric feedback.  Attributes:
    ``sf_state`` (the carried state), ``n_done``, and with
    ``keep_results=True`` ``sf_results`` (per-chunk `SFResult`)."""

    def __init__(self, addr, is_write, rid, sf_cfg: SFConfig,
                 cache_cfg: CacheConfig, graph: FabricGraph,
                 spec: CoherenceFabricSpec, *, chunk: int,
                 n_requesters: int = 1, fanout: str = "chain",
                 upgrade_bisnp: bool | None = None,
                 init_state=None, keep_results: bool = False,
                 device="cuda"):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.device = torch.device(device)
        self.addr = to_host(addr)
        self.is_write = to_host(is_write)
        self.rid = to_host(rid)
        self.sf_cfg, self.cache_cfg = sf_cfg, cache_cfg
        self.graph, self.spec = graph, spec
        self.chunk = int(chunk)
        self.n_requesters = int(n_requesters)
        self.fanout = fanout
        self.upgrade_bisnp = upgrade_bisnp
        self.sf_state = (init_state if init_state is not None
                         else sf_init_state(sf_cfg, cache_cfg, n_requesters,
                                            self.device))
        self.keep_results = keep_results
        self.sf_results: list[SFResult] = []
        self.n_done = 0

    def channels(self):
        """The engine channel table matching this stream's graph."""
        ep = self.graph.topo.endpoint
        return make_channels(self.graph, ep.row_hit_extra_ps,
                             ep.row_miss_extra_ps, device=self.device)

    def __iter__(self):
        T = self.addr.shape[0]
        for lo in range(0, T, self.chunk):
            hi = min(lo + self.chunk, T)
            a, w, r = self.addr[lo:hi], self.is_write[lo:hi], self.rid[lo:hi]
            res, ev, self.sf_state = simulate_sf(
                a, w, r, self.sf_cfg, self.cache_cfg,
                n_requesters=self.n_requesters, return_events=True,
                init_state=self.sf_state, return_state=True,
                device=self.device)
            if self.keep_results:
                self.sf_results.append(res)
            low = lower_coherence(self.graph, self.spec, self.sf_cfg,
                                  a, w, r, ev, fanout=self.fanout,
                                  upgrade_bisnp=self.upgrade_bisnp,
                                  device=self.device)
            self.n_done = hi
            yield low.hops, coherence_issue(low, ev.fab_issue_ps)
