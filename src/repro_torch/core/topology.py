"""Interconnect layer: topology graph + routing (ESF §III-A, §III-C).

The ESF interconnect layer receives, at initialization, a set of device pairs
configured as directly connected by physical links, builds an internal topology
graph, and computes a default shortest-path routing strategy that all devices
(and in particular PBR switches) query during simulation.

This module is the PyTorch port's copy of that layer (identical to
``repro.core.topology``, which is plain numpy too).  Topology construction and
all-pairs routing happen once at config time in numpy (exactly like ESF's init
phase); the resulting dense tables (channel table, next-hop matrices, routes)
are consumed by the tensorized engine (`core.engine`), which runs on torch
tensors.

Nodes are integers with a *kind* (REQUESTER / SWITCH / MEMORY).  Every physical
link materializes as either

  * two directed *channels* (full-duplex PCIe semantics; each direction gets the
    full configured bandwidth — ESF's "bandwidth allocation unit"), or
  * one shared channel with a direction-change turnaround penalty (half-duplex,
    ESF's configurable fallback used to model DDR-style buses).

Memory endpoints additionally own one or more *service channels* (one per DRAM
bank group when the banked endpoint model is enabled) so that endpoint service
contention is resolved by the same FCFS machinery as link contention.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from . import link_layer
from .link_layer import FlitConfig

REQUESTER, SWITCH, MEMORY = 0, 1, 2
KIND_NAMES = {REQUESTER: "requester", SWITCH: "switch", MEMORY: "memory"}

FULL, HALF = "full", "half"

# A value safely larger than any real path cost but far from int overflow.
_INF = np.int64(1) << 48


@dataclass(frozen=True)
class LinkSpec:
    """One configured physical link between nodes ``a`` and ``b``.

    bw_MBps      serialization bandwidth per direction, in MB/s (1e6 bytes/s).
                 For flit-mode links this is the lane rate after line
                 encoding but before flit framing (`calibration.*_RAW_MBPS`);
                 CRC/FEC flit overhead and credit caps are applied by
                 `core.link_layer`.
    fixed_ps     per-traversal fixed latency in picoseconds (port delay +
                 propagation; ESF Table III: 25 ns port + 1 ns bus).
    duplex       "full" or "half".
    turnaround_ps  half-duplex direction-change penalty.
    flit         link-layer config (`link_layer.FlitConfig`), a mode string
                 ("none" | "flit68" | "flit256"), or None for the seed's
                 byte-exact serialization.
    """

    a: int
    b: int
    bw_MBps: int
    fixed_ps: int
    duplex: str = FULL
    turnaround_ps: int = 0
    flit: FlitConfig | str | None = None


@dataclass(frozen=True)
class EndpointSpec:
    """Service model of a memory endpoint (stands in for DRAMsim3/SimpleSSD).

    ESF integrates cycle/event simulators as endpoint components (§III-E); we
    reproduce the integration seam as a pluggable latency/bandwidth/bank model.

    bw_MBps        endpoint service bandwidth (aggregated DIMM bandwidth).
    fixed_ps       controller processing time (Table III: 40 ns).
    banks          number of independently schedulable banks (1 = flat model).
    row_hit_extra_ps / row_miss_extra_ps   row-buffer model: an access to the
                 same row as the previous access to that bank pays the hit
                 cost, otherwise the miss cost (activate+precharge).
    lines_per_row  cachelines per DRAM row (for row id derivation).
    """

    bw_MBps: int = 153_600  # 4x DDR5-4800 DIMMs
    fixed_ps: int = 40_000
    banks: int = 1
    row_hit_extra_ps: int = 0
    row_miss_extra_ps: int = 0
    lines_per_row: int = 128


@dataclass
class Topology:
    """A configured system: node kinds + physical links + endpoint models."""

    kinds: np.ndarray
    links: list[LinkSpec]
    name: str = "custom"
    endpoint: EndpointSpec = field(default_factory=EndpointSpec)
    switching_ps: int = 20_000  # Table III switching time, applied per switch hop

    @property
    def n_nodes(self) -> int:
        return int(len(self.kinds))

    def requesters(self) -> np.ndarray:
        return np.where(self.kinds == REQUESTER)[0]

    def memories(self) -> np.ndarray:
        return np.where(self.kinds == MEMORY)[0]

    def build(self) -> "FabricGraph":
        return FabricGraph(self)


class FabricGraph:
    """Built topology: channel tables + all-pairs next-hop routing.

    Mirrors ESF's interconnect layer: after construction, ``route(src, dst)``
    returns the default shortest-path node sequence; ``routing_table(switch)``
    exposes the per-switch PBR table (next hop for every destination) the way
    ESF switches consume graph information to build internal routing tables.
    ``route_alternatives`` enumerates equal-cost paths for adaptive routing.
    """

    def __init__(self, topo: Topology):
        self.topo = topo
        n = topo.n_nodes
        kinds = topo.kinds

        # ---- channels ------------------------------------------------------
        # channel arrays: bw, fixed, turnaround, is_service + flit tables
        bw, fixed, turn, is_service = [], [], [], []
        f_size, f_pay, f_ppm = [], [], []
        # stochastic-reliability sampling parameters (consumed at build time
        # by devices.build_workload via link_layer.sample_hop_tables; they
        # never enter the engine's channel arrays)
        r_sto, r_p, r_win, r_thr, r_down, r_seed = [], [], [], [], [], []
        # full-duplex pairing (reverse channel of each direction; -1 for
        # half-duplex and service channels) + credit-return DLLP config
        pair, c_dllp, c_win = [], [], []
        # directed edge lookup: (u, v) -> (channel, direction flag)
        self._edge: dict[tuple[int, int], tuple[int, int]] = {}
        self._adj: list[list[int]] = [[] for _ in range(n)]
        self._link_cost = np.full((n, n), _INF, dtype=np.int64)

        for ls in topo.links:
            a, b = ls.a, ls.b
            # link-layer lowering: credit-capped bandwidth, FEC latency into
            # the per-traversal fixed cost, flit geometry + replay tables
            low = link_layer.lower_link(ls.bw_MBps, ls.flit)
            n_dirs = 2 if ls.duplex == FULL else 1
            if ls.duplex == FULL:
                c0 = len(bw)
                turn += [0, 0]
                pair += [c0 + 1, c0]
                self._edge[(a, b)] = (c0, 0)
                self._edge[(b, a)] = (c0 + 1, 0)
            else:
                c0 = len(bw)
                turn += [ls.turnaround_ps]
                pair += [-1]
                self._edge[(a, b)] = (c0, 0)
                self._edge[(b, a)] = (c0, 1)
            bw += [low.eff_bw_MBps] * n_dirs
            c_dllp += [low.credit_dllp] * n_dirs
            c_win += [low.credit_window] * n_dirs
            fixed += [ls.fixed_ps + low.extra_fixed_ps] * n_dirs
            is_service += [False] * n_dirs
            f_size += [low.flit_size] * n_dirs
            f_pay += [low.flit_payload] * n_dirs
            f_ppm += [low.replay_ppm] * n_dirs
            r_sto += [low.stochastic] * n_dirs
            r_p += [low.flit_err_p] * n_dirs
            r_win += [low.retry_window] * n_dirs
            r_thr += [low.retrain_threshold] * n_dirs
            r_down += [low.retrain_ps] * n_dirs
            r_seed += [low.rel_seed] * n_dirs
            self._adj[a].append(b)
            self._adj[b].append(a)
            cost = np.int64(ls.fixed_ps) + (1 << 20)  # hop-count dominant, latency tiebreak
            self._link_cost[a, b] = min(self._link_cost[a, b], cost)
            self._link_cost[b, a] = min(self._link_cost[b, a], cost)

        # ---- endpoint service channels (one per bank) ----------------------
        ep = topo.endpoint
        self._service_chan = np.full((n, ep.banks), -1, dtype=np.int64)
        for m in np.where(kinds == MEMORY)[0]:
            for bk in range(ep.banks):
                self._service_chan[m, bk] = len(bw)
                bw.append(ep.bw_MBps)
                fixed.append(ep.fixed_ps)
                turn.append(0)
                is_service.append(True)
                f_size.append(0)
                f_pay.append(0)
                f_ppm.append(0)
                r_sto.append(False)
                r_p.append(0.0)
                r_win.append(0)
                r_thr.append(0)
                r_down.append(0)
                r_seed.append(0)
                pair.append(-1)
                c_dllp.append(False)
                c_win.append(0)

        self.chan_bw_MBps = np.asarray(bw, dtype=np.int64)
        self.chan_fixed_ps = np.asarray(fixed, dtype=np.int64)
        self.chan_turnaround_ps = np.asarray(turn, dtype=np.int64)
        self.chan_is_service = np.asarray(is_service, dtype=bool)
        self.chan_flit_size = np.asarray(f_size, dtype=np.int64)
        self.chan_flit_payload = np.asarray(f_pay, dtype=np.int64)
        self.chan_replay_ppm = np.asarray(f_ppm, dtype=np.int64)
        self.chan_rel_stochastic = np.asarray(r_sto, dtype=bool)
        self.chan_flit_err_p = np.asarray(r_p, dtype=np.float64)
        self.chan_retry_window = np.asarray(r_win, dtype=np.int64)
        self.chan_retrain_threshold = np.asarray(r_thr, dtype=np.int64)
        self.chan_retrain_ps = np.asarray(r_down, dtype=np.int64)
        self.chan_rel_seed = np.asarray(r_seed, dtype=np.int64)
        self.chan_pair = np.asarray(pair, dtype=np.int64)
        self.chan_credit_dllp = np.asarray(c_dllp, dtype=bool)
        self.chan_credit_window = np.asarray(c_win, dtype=np.int64)
        self.n_channels = len(bw)

        # ---- all-pairs shortest paths (Floyd–Warshall w/ next-hop) ---------
        dist = self._link_cost.copy()
        np.fill_diagonal(dist, 0)
        nxt = np.where(dist < _INF, np.arange(n)[None, :], -1).astype(np.int64)
        np.fill_diagonal(nxt, np.arange(n))
        for k in range(n):
            alt = dist[:, k, None] + dist[None, k, :]
            better = alt < dist
            dist = np.where(better, alt, dist)
            nxt = np.where(better, nxt[:, k, None], nxt)
        self.dist = dist
        self.next_hop = nxt

        # equal-cost next-hop alternatives for adaptive routing (ESF switches
        # may "access detailed graph information to create dedicated routing")
        self._alt_next: list[list[list[int]]] = [[[] for _ in range(n)] for _ in range(n)]
        for u in range(n):
            for v in range(n):
                if u == v or dist[u, v] >= _INF:
                    continue
                for w in self._adj[u]:
                    if self._link_cost[u, w] + dist[w, v] == dist[u, v]:
                        self._alt_next[u][v].append(w)

    # ---- routing queries ---------------------------------------------------
    def route(self, src: int, dst: int, alt: int = 0) -> list[int]:
        """Default shortest-path node sequence src..dst.

        ``alt`` selects among equal-cost paths: at every node the ``alt``-th
        (mod fan-out) equal-cost next hop is taken — the ECMP-style alternative
        set used by the adaptive routing strategy (paper §V-A, Fig. 13).
        """
        if src == dst:
            return [src]
        if self.dist[src, dst] >= _INF:
            raise ValueError(f"no route {src}->{dst} in topology {self.topo.name!r}")
        path = [src]
        u = src
        while u != dst:
            opts = self._alt_next[u][dst]
            u = opts[alt % len(opts)]
            path.append(u)
            if len(path) > self.topo.n_nodes + 1:
                raise RuntimeError("routing loop")
        return path

    def n_route_alternatives(self, src: int, dst: int) -> int:
        """Effective count of equal-cost path alternatives: the maximum
        equal-cost branching factor along the default route (each route(alt=k)
        rotates the choice at every branching node by k)."""
        if src == dst:
            return 1
        n = 1
        u = src
        hops = 0
        while u != dst:
            opts = self._alt_next[u][dst]
            n = max(n, len(opts))
            u = opts[0]
            hops += 1
            if hops > self.topo.n_nodes:  # pragma: no cover
                raise RuntimeError("routing loop")
        return n

    def routing_table(self, switch: int) -> np.ndarray:
        """PBR routing table for one switch: next hop per destination node id.

        This is exactly the structure an ESF PBR switch builds from the
        interconnect layer's graph data (§III-C): on packet arrival it forwards
        toward ``table[dst]``.
        """
        return self.next_hop[switch].copy()

    def edge_channel(self, u: int, v: int) -> tuple[int, int]:
        """(channel id, direction flag) of directed edge u->v."""
        return self._edge[(u, v)]

    def service_channel(self, mem: int, bank: int = 0) -> int:
        c = int(self._service_chan[mem, bank % self.topo.endpoint.banks])
        if c < 0:
            raise ValueError(f"node {mem} is not a memory endpoint")
        return c

    def hops(self, src: int, dst: int) -> int:
        return len(self.route(src, dst)) - 1


# ---------------------------------------------------------------------------
# Topology builders for the paper's five studied fabrics (Fig. 9) + CXL basics
# ---------------------------------------------------------------------------

def _mk(kinds: Sequence[int], links: list[LinkSpec], name: str, **kw) -> Topology:
    return Topology(np.asarray(kinds, dtype=np.int64), links, name=name, **kw)


def _pair_switch_nodes(n_pairs: int, per_leaf: int = 1):
    """kinds + attach lists for the §V-A fabrics: N requesters on one side of
    the fabric, N memories on the other (the segregation visible in Fig. 9 —
    it is what makes every request/response cross the fabric and lets the
    'bridge' routes of chain/tree saturate at exactly one port's bandwidth).

    Returns (kinds, switch_ids, req_ids, mem_ids, leaf_of) where the first
    half of switch_ids host requesters and the second half host memories.
    """
    kinds: list[int] = []
    reqs, mems, leaf_of_req, leaf_of_mem = [], [], [], []
    n_side = max(n_pairs // per_leaf, 1)
    switches = list(range(2 * n_side))
    kinds += [SWITCH] * (2 * n_side)
    for i in range(n_pairs):
        reqs.append(len(kinds))
        kinds.append(REQUESTER)
        leaf_of_req.append(i // per_leaf)
    for i in range(n_pairs):
        mems.append(len(kinds))
        kinds.append(MEMORY)
        leaf_of_mem.append(n_side + i // per_leaf)
    return kinds, switches, reqs, mems, (leaf_of_req, leaf_of_mem)


def _attach_endpoints(links, reqs, mems, leaf_of, switches, bw, fixed):
    leaf_of_req, leaf_of_mem = leaf_of
    for r, lf in zip(reqs, leaf_of_req):
        links.append(LinkSpec(r, switches[lf], bw, fixed))
    for m, lf in zip(mems, leaf_of_mem):
        links.append(LinkSpec(m, switches[lf], bw, fixed))


def chain(n_pairs: int, bw_MBps: int = 64_000, fixed_ps: int = 26_000, **kw) -> Topology:
    """N leaf switches in a line, each hosting one requester + one memory."""
    kinds, sw, reqs, mems, leaf_of = _pair_switch_nodes(n_pairs)
    links: list[LinkSpec] = []
    for i in range(len(sw) - 1):
        links.append(LinkSpec(sw[i], sw[i + 1], bw_MBps, fixed_ps))
    _attach_endpoints(links, reqs, mems, leaf_of, sw, bw_MBps, fixed_ps)
    return _mk(kinds, links, f"chain{n_pairs}", **kw)


def tree(n_pairs: int, bw_MBps: int = 64_000, fixed_ps: int = 26_000, **kw) -> Topology:
    """Binary tree of switches; leaf switches host one requester + one memory.

    Routes adjacent to the root are the 'bridge' routes of paper §V-A.
    """
    kinds, sw, reqs, mems, leaf_of = _pair_switch_nodes(n_pairs)
    links: list[LinkSpec] = []
    # build a binary tree over the leaf switches: internal switches appended
    level = list(sw)
    next_id = len(kinds)
    while len(level) > 1:
        parents = []
        for i in range(0, len(level), 2):
            p = next_id
            next_id += 1
            kinds.append(SWITCH)
            links.append(LinkSpec(level[i], p, bw_MBps, fixed_ps))
            if i + 1 < len(level):
                links.append(LinkSpec(level[i + 1], p, bw_MBps, fixed_ps))
            parents.append(p)
        level = parents
    _attach_endpoints(links, reqs, mems, leaf_of, sw, bw_MBps, fixed_ps)
    return _mk(kinds, links, f"tree{n_pairs}", **kw)


def ring(n_pairs: int, bw_MBps: int = 64_000, fixed_ps: int = 26_000, **kw) -> Topology:
    kinds, sw, reqs, mems, leaf_of = _pair_switch_nodes(n_pairs)
    links: list[LinkSpec] = []
    for i in range(len(sw)):
        links.append(LinkSpec(sw[i], sw[(i + 1) % len(sw)], bw_MBps, fixed_ps))
    _attach_endpoints(links, reqs, mems, leaf_of, sw, bw_MBps, fixed_ps)
    return _mk(kinds, links, f"ring{n_pairs}", **kw)


def spine_leaf(n_pairs: int, n_spines: int = 2, per_leaf: int = 2,
               bw_MBps: int = 64_000, fixed_ps: int = 26_000, **kw) -> Topology:
    """Leaves host ``per_leaf`` requester/memory pairs; every leaf uplinks to
    every spine.  With per_leaf=2 and 2 spines the leaf uplinks are 2:1
    oversubscribed against endpoint ports, reproducing the paper's N/2 scaling
    (§V-A observes residual 'competition among requesters on ports in leaf
    switches')."""
    kinds, leaves, reqs, mems, leaf_of = _pair_switch_nodes(n_pairs, per_leaf=per_leaf)
    links: list[LinkSpec] = []
    spines = []
    for _ in range(n_spines):
        spines.append(len(kinds))
        kinds.append(SWITCH)
    for lf in leaves:
        for sp in spines:
            links.append(LinkSpec(lf, sp, bw_MBps, fixed_ps))
    _attach_endpoints(links, reqs, mems, leaf_of, leaves, bw_MBps, fixed_ps)
    return _mk(kinds, links, f"spineleaf{n_pairs}", **kw)


def fully_connected(n_pairs: int, bw_MBps: int = 64_000, fixed_ps: int = 26_000, **kw) -> Topology:
    kinds, sw, reqs, mems, leaf_of = _pair_switch_nodes(n_pairs)
    links: list[LinkSpec] = []
    for i in range(len(sw)):
        for j in range(i + 1, len(sw)):
            links.append(LinkSpec(sw[i], sw[j], bw_MBps, fixed_ps))
    _attach_endpoints(links, reqs, mems, leaf_of, sw, bw_MBps, fixed_ps)
    return _mk(kinds, links, f"fc{n_pairs}", **kw)


def single_bus(n_mems: int = 4, bw_MBps: int = 64_000, fixed_ps: int = 26_000,
               duplex: str = FULL, turnaround_ps: int = 0, **kw) -> Topology:
    """The §IV validation system: one requester -- bus(switch) -- N memories."""
    kinds = [REQUESTER, SWITCH] + [MEMORY] * n_mems
    links = [LinkSpec(0, 1, bw_MBps, fixed_ps, duplex, turnaround_ps)]
    for m in range(n_mems):
        links.append(LinkSpec(1, 2 + m, bw_MBps, fixed_ps, duplex, turnaround_ps))
    return _mk(kinds, links, f"bus{n_mems}", **kw)


def with_flit(topo: Topology, flit: FlitConfig | str | None) -> Topology:
    """Copy of ``topo`` with every physical link running the given flit
    config — the one-liner that moves a whole fabric between byte-exact,
    68 B-flit (PCIe 5 / CXL 2.0) and 256 B-flit (PCIe 6 / CXL 3.x) modes."""
    from dataclasses import replace as _replace

    return Topology(
        topo.kinds.copy(),
        [_replace(ls, flit=flit) for ls in topo.links],
        name=topo.name, endpoint=topo.endpoint,
        switching_ps=topo.switching_ps,
    )


TOPOLOGY_BUILDERS = {
    "chain": chain,
    "tree": tree,
    "ring": ring,
    "spine_leaf": spine_leaf,
    "fully_connected": fully_connected,
}
