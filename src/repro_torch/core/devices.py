"""Device layer: computational components (requesters) and workload building.

The PyTorch port's copy of ``repro.core.devices``: the lowering stays numpy
(so the seeded draws equal the reference's bit for bit) and the finished
tables become torch tensors on the requested device.

ESF's computational component (§III-B) has three units:

  * request queue — issue capability, modeled by an inter-issue interval
    (open-loop intensity control; the loaded-latency knob of §IV),
  * address translation unit — interleaving policy across memory endpoints,
  * cache-coherence management unit — collaborates with the DCOH; handled in
    `core.snoop_filter` and composed with this layer by the benches.

``build_workload`` turns a set of RequesterSpecs into the dense hop tables the
engine consumes: for each access it resolves the route (default shortest-path
from the interconnect layer, or one of the equal-cost alternatives under the
adaptive strategy), then emits request hops, the endpoint service hop, and
response hops.

Packetization (header model, paper §V-D): a read sends a header-sized request
packet toward the endpoint and a payload-sized response back; a write sends
the payload toward the endpoint and a header-sized completion back.  This is
the model under which single-type traffic leaves one full-duplex direction to
headers only (utility 1/2 at zero header overhead) and a 1:1 mix doubles
bandwidth — and under which the gain vanishes exactly when header == payload,
matching Fig. 16/17.  A "symmetric" variant (headers on every packet) is also
provided for sensitivity runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from .topology import FabricGraph, SWITCH
from .engine import (Channels, Hops, make_channels, resolve_device,
                     to_device, to_host)
from . import link_layer

HEADER_MODELS = ("esf", "symmetric")


def packetize(header_model: str, write: bool, payload: int,
              header_bytes: int) -> tuple[int, int, bool, bool]:
    """Logical forward/backward packet bytes of one access (paper §V-D).

    Returns (fwd_bytes, bwd_bytes, fwd_is_payload, bwd_is_payload).  Bytes
    are *logical* TLP bytes; flit-mode channels quantize them to whole-flit
    wire bytes during serialization (`link_layer` lowering contract), so the
    byte-exact ``flit_mode="none"`` path is untouched.
    """
    if header_model == "esf":
        fwd_b = payload if write else header_bytes
        bwd_b = header_bytes if write else payload
    else:  # symmetric: header on every packet, payload rides with data
        fwd_b = header_bytes + (payload if write else 0)
        bwd_b = header_bytes + (0 if write else payload)
    return fwd_b, bwd_b, write, not write


@dataclass
class RequesterSpec:
    """One requester's traffic program (open loop)."""

    node: int
    n_requests: int
    targets: Sequence[int]
    pattern: str = "uniform"        # uniform | stream | skewed | trace
    read_ratio: float = 1.0
    issue_interval_ps: int = 10_000
    start_ps: int = 0
    payload_bytes: int = 64
    seed: int = 0
    # skewed pattern: hot fraction of footprint getting hot_ratio of accesses
    footprint_lines: int = 4096
    hot_frac: float = 0.1
    hot_ratio: float = 0.9
    issue_jitter: str = "none"      # "none" | "exp" (Poisson arrivals)
    # trace replay (ESF trace-based mode): overrides pattern when set
    trace_addr: np.ndarray | None = None
    trace_is_write: np.ndarray | None = None
    trace_interval_ps: np.ndarray | None = None


@dataclass
class Workload:
    hops: Hops
    channels: Channels
    issue_ps: torch.Tensor      # (N,) int64, on the workload's device
    payload_bytes: torch.Tensor  # (N,) int64
    measured: torch.Tensor      # (N,) bool
    requester: np.ndarray       # (N,) requester node per transaction
    target: np.ndarray          # (N,) memory node per transaction
    is_write: np.ndarray
    n_link_hops: np.ndarray     # (N,) link hops one way (for Fig. 11 grouping)
    route_alt: np.ndarray       # (N,) which equal-cost alternative was taken

    @property
    def n_demand(self) -> int:
        """Count of real (routable) demand transactions.  ``build_workload``
        appends pseudo-rows — credit-return DLLPs, requester -1 — *after*
        the demand rows, and their count is route-dependent: anything that
        indexes per-transaction route choices (`core.routing`) or
        per-request metrics must address the demand prefix only."""
        return int((self.requester >= 0).sum())


def _gen_addresses(spec: RequesterSpec, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = spec.n_requests
    if spec.trace_addr is not None:
        addr = np.asarray(spec.trace_addr[:n], dtype=np.int64)
        wr = np.asarray(spec.trace_is_write[:n], dtype=bool)
        iv = (np.asarray(spec.trace_interval_ps[:n], dtype=np.int64)
              if spec.trace_interval_ps is not None
              else np.full(n, spec.issue_interval_ps, np.int64))
        return addr, wr, iv
    if spec.pattern == "stream":
        addr = np.arange(n, dtype=np.int64) % spec.footprint_lines
    elif spec.pattern == "skewed":
        hot_n = max(int(spec.footprint_lines * spec.hot_frac), 1)
        is_hot = rng.random(n) < spec.hot_ratio
        addr = np.where(
            is_hot,
            rng.integers(0, hot_n, n),
            hot_n + rng.integers(0, max(spec.footprint_lines - hot_n, 1), n),
        ).astype(np.int64)
    else:  # uniform
        addr = rng.integers(0, spec.footprint_lines, n).astype(np.int64)
    wr = rng.random(n) >= spec.read_ratio
    if spec.issue_jitter == "exp":
        iv = np.maximum(rng.exponential(spec.issue_interval_ps, n), 1).astype(np.int64)
    else:
        iv = np.full(n, spec.issue_interval_ps, np.int64)
    return addr, wr, iv


def _interleave(addr: np.ndarray, targets: Sequence[int], policy: str) -> np.ndarray:
    """Address translation unit: map line address -> endpoint (§III-B)."""
    t = np.asarray(targets, dtype=np.int64)
    if policy == "line":          # fine-grained line interleaving
        return t[addr % len(t)]
    if policy == "block":         # contiguous block per endpoint
        return t[(addr * len(t)) // max(int(addr.max()) + 1, 1) % len(t)]
    raise ValueError(f"unknown interleave policy {policy!r}")


def _credit_dllp_plan(graph: FabricGraph, override: link_layer.FlitConfig):
    """Per-channel credit-DLLP emission tables, or None when disabled.

    Returns (enabled mask, window flits, flit payload) — a channel emits
    one `calibration.CREDIT_DLLP_B`-byte hop on its full-duplex pair
    (`FabricGraph.chan_pair`) per ``window`` flits transmitted.  Minimal
    version: half-duplex links (no pair) never emit.
    """
    has_pair = graph.chan_pair >= 0
    if override.active:
        if not override.credit_dllp:
            return None
        size, payload = override.geometry
        mask = has_pair & ~graph.chan_is_service & (size > 0)
        window = np.full(graph.n_channels, max(override.rx_credits, 1))
        pay = np.full(graph.n_channels, max(payload, 1))
    else:
        mask = (np.asarray(graph.chan_credit_dllp, bool) & has_pair
                & (graph.chan_flit_size > 0))
        window = np.maximum(graph.chan_credit_window, 1)
        pay = np.maximum(graph.chan_flit_payload, 1)
    if not mask.any():
        return None
    return mask, window.astype(np.int64), pay.astype(np.int64)


def finish_hops(graph: FabricGraph, flit_cfg: "link_layer.FlitConfig",
                chan, nbytes, direction, row_id, fixed_after, is_payload,
                valid, stream_salt: int = 0, join_id=None, join_wait=None,
                join_arity=None, device="cuda") -> Hops:
    """Final build step shared by every hop-table producer: sample the
    stochastic link-reliability tables (when the graph or override carries
    them) and mirror full-duplex retraining stalls onto the paired channel
    as link-down markers, then assemble the engine `Hops`.

    Deterministic graphs return the arrays untouched (bit-exact layout).
    ``stream_salt`` offsets the per-channel sampling seeds — hop tables
    that will be co-scheduled with another table built from the same graph
    (e.g. coherence rows alongside a background workload) must pass a
    distinct salt, or the two tables replay byte-identical fault
    histories instead of independent draws.

    The optional per-row ``join_id``/``join_wait``/``join_arity`` triple
    (the engine fork/join primitive, all three or none) passes through
    untouched: marker insertion only shifts hop *columns*, never rows.
    The tables are copied onto ``device``.
    """
    dev = resolve_device(device)
    joins = (join_id, join_wait, join_arity)
    if any(j is not None for j in joins) and any(j is None for j in joins):
        raise ValueError("join_id/join_wait/join_arity come as a triple")
    extra_wire = retrain_after = None
    rel = _reliability_tables(graph, flit_cfg)
    if rel is not None:
        if stream_salt:
            rel = dict(rel, rel_seed=np.asarray(rel["rel_seed"])
                       + stream_salt)
        extra_wire, retrain_after = link_layer.sample_hop_tables(
            chan, nbytes, valid, **rel)
        (chan, nbytes, direction, row_id, fixed_after, is_payload, valid,
         extra_wire, retrain_after) = link_layer.insert_retrain_markers(
            chan, nbytes, direction, row_id, fixed_after, is_payload,
            valid, extra_wire, retrain_after, graph.chan_pair)
    hops = Hops(*(to_device(a, dev) for a in
                  (chan, nbytes, direction, row_id, fixed_after, is_payload,
                   valid)))
    if extra_wire is not None:
        hops = hops._replace(extra_wire_bytes=to_device(extra_wire, dev),
                             retrain_after_ps=to_device(retrain_after, dev))
    if join_id is not None:
        hops = hops._replace(**{
            name: to_device(np.asarray(tab, np.int32), dev)
            for name, tab in (("join_id", join_id), ("join_wait", join_wait),
                              ("join_arity", join_arity))})
    return hops


def marker_column_map(hops: Hops) -> np.ndarray:
    """Map pre-marker hop columns to their post-`finish_hops` positions.

    ``out[j, i]`` is the column the original hop ``(j, i)`` occupies in
    the finished table (the identity when no markers were inserted) — the
    remap consumers of a fixed column layout (e.g.
    `coherence_traffic.bisnp_latencies`) apply to read the schedule back.
    """
    chan = to_host(hops.channel)
    mk = link_layer.retrain_marker_mask(
        chan, to_host(hops.nbytes), to_host(hops.valid),
        None if hops.retrain_after_ps is None
        else to_host(hops.retrain_after_ps))
    h_old = chan.shape[1] - (int(mk.sum(axis=1).max()) if mk.any() else 0)
    # stable argsort puts each row's non-marker columns first, in order
    return np.argsort(mk, axis=1, kind="stable")[:, :h_old].astype(np.int64)


def _reliability_tables(graph: FabricGraph, override: link_layer.FlitConfig):
    """Per-channel stochastic-sampling parameters, or None when every
    channel runs the deterministic expected-value model.

    Graph-carried flit configs (`LinkSpec.flit`) supply per-channel tables;
    a workload-level override broadcasts one config over the link channels
    (service channels never sample — they are byte-exact by contract).
    """
    if override.active:
        if not override.stochastic:
            return None
        return link_layer.broadcast_reliability_tables(
            override, graph.n_channels, ~graph.chan_is_service)
    if not np.any(graph.chan_rel_stochastic):
        return None
    return dict(
        stochastic=graph.chan_rel_stochastic,
        err_p=graph.chan_flit_err_p,
        flit_size=graph.chan_flit_size,
        flit_payload=graph.chan_flit_payload,
        retry_window=graph.chan_retry_window,
        retrain_threshold=graph.chan_retrain_threshold,
        retrain_ps=graph.chan_retrain_ps,
        rel_seed=graph.chan_rel_seed,
    )


def build_workload(
    graph: FabricGraph,
    specs: Sequence[RequesterSpec],
    header_bytes: int = 64,
    header_model: str = "esf",
    interleave: str = "line",
    warmup_frac: float = 0.5,
    route_choice: np.ndarray | None = None,
    requester_overhead_ps: int = 22_000,   # Table III: 10 ns process + 12 ns cache
    flit: "link_layer.FlitConfig | str | None" = None,
    device="cuda",
) -> Workload:
    """Expand requester traffic programs into engine hop tables.

    ``route_choice`` (optional, per-transaction int) selects among equal-cost
    route alternatives — the hook the adaptive routing strategy uses
    (see `core.routing.adaptive_schedule`).

    ``flit`` overrides the link layer of every *link* channel (service
    channels stay byte-exact) without rebuilding the graph: hop bytes are
    emitted logically and the flit tables installed on ``Workload.channels``
    quantize them to wire flits in the engine, while the per-hop FEC decode
    latency is added to ``fixed_after`` here.  ``None`` defers to the flit
    configs already carried by the graph's ``LinkSpec``s (which may also be
    "none" — the seed's byte-exact path, bit-for-bit).  Passing any explicit
    config (even "none") on a graph whose links already carry flit configs
    raises: the graph's lowering is baked into its channel tables, so switch
    modes by rebuilding the topology (`topology.with_flit`).

    The hop tables, ``channels``, ``issue_ps``, ``payload_bytes`` and
    ``measured`` are tensors on ``device`` (the card by default; a machine
    without one raises unless the caller passes ``device="cpu"``); the
    per-transaction bookkeeping fields stay numpy.
    """
    dev = resolve_device(device)
    if header_model not in HEADER_MODELS:
        raise ValueError(f"unknown header model {header_model!r}; "
                         f"expected one of {HEADER_MODELS}")
    ep = graph.topo.endpoint
    flit_cfg = link_layer.normalize(flit)
    if flit is not None and np.any(graph.chan_flit_size > 0):
        # an active override would double-count FEC latency, and an explicit
        # "none" cannot un-fold the FEC already baked into chan_fixed_ps —
        # rebuild the topology (with_flit(topo, ...)) instead
        raise ValueError(
            "graph links already carry flit configs (LinkSpec.flit); "
            "rebuild the topology with the desired flit mode (e.g. "
            "with_flit(topo, ...)) instead of overriding at workload level")
    flit_fec_ps = flit_cfg.fec_latency_ps if flit_cfg.active else 0

    rows: list[dict] = []
    tx = 0
    for spec in specs:
        rng = np.random.default_rng(spec.seed + 7919 * spec.node)
        addr, wr, iv = _gen_addresses(spec, rng)
        tgt = _interleave(addr, spec.targets, interleave)
        t = spec.start_ps + np.cumsum(iv) - iv[0]
        for i in range(spec.n_requests):
            rows.append(dict(
                req=spec.node, mem=int(tgt[i]), write=bool(wr[i]),
                addr=int(addr[i]), issue=int(t[i]) + requester_overhead_ps,
                payload=spec.payload_bytes, idx=tx, ntgt=len(spec.targets),
                measured=i >= int(spec.n_requests * warmup_frac),
            ))
            tx += 1

    n = len(rows)
    # resolve routes; longest path defines padding
    paths = []
    alts = np.zeros(n, dtype=np.int64)
    for j, r in enumerate(rows):
        alt = int(route_choice[j]) if route_choice is not None else 0
        alts[j] = alt % graph.n_route_alternatives(r["req"], r["mem"])
        paths.append(graph.route(r["req"], r["mem"], alt=alt))
    max_links = max(len(p) - 1 for p in paths)
    h = 2 * max_links + 1  # request hops + service + response hops

    channel = np.full((n, h), -1, dtype=np.int32)
    nbytes = np.zeros((n, h), dtype=np.int64)
    direction = np.zeros((n, h), dtype=np.int8)
    row_id = np.full((n, h), -1, dtype=np.int32)
    fixed_after = np.zeros((n, h), dtype=np.int64)
    is_payload = np.zeros((n, h), dtype=bool)
    valid = np.zeros((n, h), dtype=bool)

    sw_ps = graph.topo.switching_ps
    for j, (r, path) in enumerate(zip(rows, paths)):
        write = r["write"]
        pay = r["payload"]
        fwd_b, bwd_b, fwd_pay, bwd_pay = packetize(
            header_model, write, pay, header_bytes)
        k = 0
        for u, v in zip(path[:-1], path[1:]):
            c, d = graph.edge_channel(u, v)
            channel[j, k] = c
            nbytes[j, k] = fwd_b
            direction[j, k] = d
            fixed_after[j, k] = (graph.chan_fixed_ps[c] + flit_fec_ps
                                 + (sw_ps if graph.topo.kinds[v] == SWITCH else 0))
            is_payload[j, k] = fwd_pay
            valid[j, k] = True
            k += 1
        # endpoint service hop (banked; row-buffer state carried per bank).
        # The line-interleave across endpoints consumes the low addr bits, so
        # bank/row derive from the per-endpoint line index (addr // n_targets)
        # — otherwise every request to an endpoint would land in one bank.
        ep_line = r["addr"] // max(r["ntgt"], 1)
        bank = ep_line % ep.banks
        c = graph.service_channel(r["mem"], bank)
        channel[j, k] = c
        nbytes[j, k] = pay
        row_id[j, k] = (ep_line // ep.lines_per_row) % (1 << 30)
        fixed_after[j, k] = ep.fixed_ps
        is_payload[j, k] = True
        valid[j, k] = True
        k += 1
        for u, v in zip(path[::-1][:-1], path[::-1][1:]):
            c, d = graph.edge_channel(u, v)
            channel[j, k] = c
            nbytes[j, k] = bwd_b
            direction[j, k] = d
            fixed_after[j, k] = (graph.chan_fixed_ps[c] + flit_fec_ps
                                 + (sw_ps if graph.topo.kinds[v] == SWITCH else 0))
            is_payload[j, k] = bwd_pay
            valid[j, k] = True
            k += 1

    # ---- credit-return DLLP traffic (FlitConfig(credit_dllp=True)) -------
    # every credit-return window of flits transmitted on a full-duplex flit
    # channel emits one DLLP-sized hop on the paired reverse channel, issued
    # with the transaction that crossed the window boundary (build-time
    # approximation) — credit starvation couples to reverse congestion.
    dllp = _credit_dllp_plan(graph, flit_cfg)
    if dllp is not None:
        from .calibration import CREDIT_DLLP_B

        d_mask, d_win, d_pay = dllp
        cum = np.zeros(graph.n_channels, np.int64)
        d_rows: list[tuple[int, int]] = []   # (issue_ps, reverse channel)
        # accumulate in issue-time order, not build (requester-major) order,
        # so each window's DLLP is stamped with the transaction that
        # actually crossed it when several requesters share a channel
        order = np.argsort([r["issue"] for r in rows], kind="stable")
        for j in order:
            for k in range(h):
                c = channel[j, k]
                if not valid[j, k] or c < 0 or not d_mask[c] \
                        or nbytes[j, k] <= 0:
                    continue
                cum[c] += -(-nbytes[j, k] // d_pay[c])
                while cum[c] >= d_win[c]:
                    cum[c] -= d_win[c]
                    d_rows.append((rows[j]["issue"], int(graph.chan_pair[c])))
        if d_rows:
            m = len(d_rows)
            channel = np.vstack([channel, np.full((m, h), -1, np.int32)])
            nbytes = np.vstack([nbytes, np.zeros((m, h), np.int64)])
            direction = np.vstack([direction, np.zeros((m, h), np.int8)])
            row_id = np.vstack([row_id, np.full((m, h), -1, np.int32)])
            fixed_after = np.vstack([fixed_after, np.zeros((m, h), np.int64)])
            is_payload = np.vstack([is_payload, np.zeros((m, h), bool)])
            valid = np.vstack([valid, np.zeros((m, h), bool)])
            for i, (iss, rc) in enumerate(d_rows):
                channel[n + i, 0] = rc
                nbytes[n + i, 0] = CREDIT_DLLP_B
                # same per-hop fixed cost as every other hop on this path
                # (flit_fec_ps is nonzero only on the override path; the
                # graph-carried path bakes FEC into chan_fixed_ps)
                fixed_after[n + i, 0] = graph.chan_fixed_ps[rc] + flit_fec_ps
                valid[n + i, 0] = True
                rows.append(dict(req=-1, mem=-1, write=False, addr=0,
                                 issue=iss, payload=0, idx=n + i, ntgt=1,
                                 measured=False))
                paths.append([-1, -1])
            alts = np.concatenate([alts, np.zeros(m, np.int64)])
            n += m

    # stochastic link reliability: sample the per-hop replay/retraining
    # tables from the seeded per-channel streams (build time, like issue
    # jitter) and mirror full-duplex retraining stalls onto the paired
    # channel.  The expected-value mode leaves Hops in the deterministic
    # layout untouched.
    hops = finish_hops(graph, flit_cfg, channel, nbytes, direction, row_id,
                       fixed_after, is_payload, valid, device=dev)
    channels = make_channels(graph, ep.row_hit_extra_ps, ep.row_miss_extra_ps,
                             device=dev)
    if flit_cfg.active:
        channels = link_layer.apply_flit(
            channels, ~graph.chan_is_service, flit_cfg)
    return Workload(
        hops=hops,
        channels=channels,
        issue_ps=to_device(np.array([r["issue"] for r in rows], np.int64), dev),
        payload_bytes=to_device(
            np.array([r["payload"] for r in rows], np.int64), dev),
        measured=to_device(np.array([r["measured"] for r in rows], bool), dev),
        requester=np.array([r["req"] for r in rows], np.int64),
        target=np.array([r["mem"] for r in rows], np.int64),
        is_write=np.array([r["write"] for r in rows], bool),
        n_link_hops=np.array([len(p) - 1 for p in paths], np.int64),
        route_alt=alts,
    )
