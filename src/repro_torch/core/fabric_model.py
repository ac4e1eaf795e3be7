"""TPU fabric as an ESF topology: collective cost prediction, on the port.

The counterpart of ``repro.core.fabric_model``: the paper's insight — make
the interconnect a first-class simulated object (topology graph + per-link
contention + duplex semantics) and use it to predict system behaviour —
applied to a TPU v5e pod (16x16 chips, 2D torus ICI) joined by DCN.  The
pod is the *simulated* fabric: collectives lower to transaction sets over
its graph, and the exact FCFS engine (`core.engine.simulate`, on the
tables' device; on the card one fused serve-round launch a round) resolves
their completion time, *including* contention between overlapping
transfers.  The sharding autotuner (`core.autotune`) and the straggler
what-if (`runtime.straggler`) use these predictions as their cost model.

The constants below are parameters of the simulated v5e pod, not rates of
the machine the port runs on: 197 bf16 TFLOP/s and 819 GB/s HBM per chip,
~50 GB/s per ICI link per direction, a DCN per-chip share of 6.4 GB/s.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import engine
from .engine import Hops, make_channels, resolve_device, to_device
from .topology import REQUESTER, SWITCH, EndpointSpec, LinkSpec, Topology

# the simulated v5e pod's parameters
V5E_PEAK_FLOPS = 197e12
V5E_HBM_BPS = 819e9
V5E_ICI_MBPS = 50_000          # per link per direction
V5E_DCN_MBPS = 6_400           # per chip share of cross-pod bandwidth
ICI_HOP_PS = 1_000             # per-hop fixed latency
DCN_RTT_PS = 5_000_000


@dataclass(frozen=True)
class TPUFabric:
    """A pod-of-chips fabric graph. Chips are REQUESTER nodes; the engine's
    generic channels model ICI links (full duplex, both directions)."""

    nx: int
    ny: int
    pods: int = 1
    ici_MBps: int = V5E_ICI_MBPS
    dcn_MBps: int = V5E_DCN_MBPS

    def chip(self, pod: int, x: int, y: int) -> int:
        return pod * self.nx * self.ny + (x % self.nx) * self.ny + (y % self.ny)

    def build(self):
        n_chips = self.pods * self.nx * self.ny
        kinds = [REQUESTER] * n_chips
        links: list[LinkSpec] = []
        for p in range(self.pods):
            for x in range(self.nx):
                for y in range(self.ny):
                    a = self.chip(p, x, y)
                    if self.nx > 1:
                        links.append(LinkSpec(a, self.chip(p, x + 1, y),
                                              self.ici_MBps, ICI_HOP_PS))
                    if self.ny > 1:
                        links.append(LinkSpec(a, self.chip(p, x, y + 1),
                                              self.ici_MBps, ICI_HOP_PS))
        # cross-pod DCN: per-chip NIC into a per-pod aggregation switch
        if self.pods > 1:
            agg = []
            for p in range(self.pods):
                kinds.append(SWITCH)  # routes traffic, owns no endpoint
                agg.append(n_chips + p)
            for p in range(self.pods):
                for q in range(p + 1, self.pods):
                    links.append(LinkSpec(agg[p], agg[q],
                                          self.dcn_MBps * self.nx * self.ny,
                                          DCN_RTT_PS))
                for x in range(self.nx):
                    for y in range(self.ny):
                        links.append(LinkSpec(self.chip(p, x, y), agg[p],
                                              self.dcn_MBps, DCN_RTT_PS // 4))
        topo = Topology(np.asarray(kinds, np.int64), links, name="tpu-fabric",
                        endpoint=EndpointSpec(bw_MBps=1, banks=1), switching_ps=0)
        return topo.build()


def _transfer_hops(graph, pairs, nbytes, device="cuda") -> Hops:
    """Hop tables, on ``device``, for a set of simultaneous point-to-point
    transfers.

    pairs: list of (src, dst); nbytes: per-transfer payload bytes.
    Dimension-ordered shortest-path routes from the interconnect layer.
    """
    paths = [graph.route(s, d) for s, d in pairs]
    h = max(len(p) - 1 for p in paths)
    n = len(pairs)
    channel = np.full((n, h), -1, np.int32)
    nb = np.zeros((n, h), np.int64)
    fixed = np.zeros((n, h), np.int64)
    valid = np.zeros((n, h), bool)
    for j, p in enumerate(paths):
        for k, (u, v) in enumerate(zip(p[:-1], p[1:])):
            c, _ = graph.edge_channel(u, v)
            channel[j, k] = c
            nb[j, k] = nbytes[j] if np.ndim(nbytes) else nbytes
            fixed[j, k] = graph.chan_fixed_ps[c]
            valid[j, k] = True
    dev = resolve_device(device)
    return Hops(
        channel=to_device(channel, dev), nbytes=to_device(nb, dev),
        direction=to_device(np.zeros((n, h), np.int8), dev),
        row=to_device(np.full((n, h), -1, np.int32), dev),
        fixed_after_ps=to_device(fixed, dev),
        is_payload=to_device(valid, dev), valid=to_device(valid, dev),
    )


def simulate_transfers(graph, pairs, nbytes, device="cuda",
                       simulate_fn=None) -> float:
    """Makespan (seconds) of simultaneous transfers under exact contention.

    The schedule comes from ``simulate_fn(hops, channels, issue_ps)``
    (`engine.simulate`, the computed round budget, unless the caller
    records or times it) on ``device``; one scalar, the latest completion,
    is read back and divided on the host, as the reference does."""
    hops = _transfer_hops(graph, pairs, nbytes, device)
    ch = make_channels(graph, device=device)
    issue = torch.zeros(len(pairs), dtype=torch.int64,
                        device=hops.channel.device)
    sched = (simulate_fn or engine.simulate)(hops, ch, issue)
    return int(sched.complete.max()) / 1e12


@dataclass
class CollectiveEstimate:
    kind: str
    axis_size: int
    bytes_per_chip: int
    seconds: float
    steps: int
    detail: str = ""


def ring_neighbors(fabric: TPUFabric, axis: str):
    """Chip pairs forming the bidirectional ring steps along a mesh axis."""
    pairs = []
    for p in range(fabric.pods):
        for x in range(fabric.nx):
            for y in range(fabric.ny):
                a = fabric.chip(p, x, y)
                b = (fabric.chip(p, x + 1, y) if axis == "x"
                     else fabric.chip(p, x, y + 1))
                pairs.append((a, b))
                pairs.append((b, a))
    return pairs


def predict_collective(fabric: TPUFabric, graph, kind: str, axis: str,
                       bytes_per_chip: int, device="cuda",
                       simulate_fn=None) -> CollectiveEstimate:
    """Predict collective completion time on the fabric.

    ring collectives (all_reduce / all_gather / reduce_scatter) run
    bidirectional rings along a torus axis; all_to_all issues all pairwise
    transfers at once (the contention-heavy case the ESF engine exists for).
    Each resolves one schedule on ``device`` (`simulate_transfers`).
    """
    ax = fabric.nx if axis == "x" else fabric.ny
    if kind in ("all_reduce", "all_gather", "reduce_scatter"):
        shard = max(bytes_per_chip // ax, 1) // 2  # bidirectional: half each way
        pairs = ring_neighbors(fabric, axis)
        t_step = simulate_transfers(graph, pairs, shard, device, simulate_fn)
        steps = (2 * (ax - 1)) if kind == "all_reduce" else (ax - 1)
        return CollectiveEstimate(kind, ax, bytes_per_chip, t_step * steps,
                                  steps, f"bidir ring along {axis}")
    if kind == "all_to_all":
        pairs, sizes = [], []
        per = max(bytes_per_chip // ax, 1)
        for p in range(fabric.pods):
            for x in range(fabric.nx):
                for y in range(fabric.ny):
                    a = fabric.chip(p, x, y)
                    for k in range(1, ax):
                        b = (fabric.chip(p, x + k, y) if axis == "x"
                             else fabric.chip(p, x, y + k))
                        pairs.append((a, b))
                        sizes.append(per)
        t = simulate_transfers(graph, pairs, np.asarray(sizes), device,
                               simulate_fn)
        return CollectiveEstimate(kind, ax, bytes_per_chip, t, 1,
                                  f"direct pairwise along {axis}")
    if kind == "pod_all_reduce":
        # cross-pod gradient reduction over DCN aggregation
        pairs = []
        for p in range(fabric.pods):
            for x in range(fabric.nx):
                for y in range(fabric.ny):
                    a = fabric.chip(p, x, y)
                    b = fabric.chip((p + 1) % fabric.pods, x, y)
                    if a != b:
                        pairs.append((a, b))
        shard = max(bytes_per_chip // max(fabric.pods, 2), 1)
        t_step = simulate_transfers(graph, pairs, shard, device, simulate_fn)
        steps = 2 * (fabric.pods - 1)
        return CollectiveEstimate(kind, fabric.pods, bytes_per_chip,
                                  t_step * steps, steps, "DCN ring across pods")
    raise ValueError(f"unknown collective {kind!r}")


def analytic_ring_seconds(bytes_per_chip: int, axis: int,
                          link_MBps: int = V5E_ICI_MBPS) -> float:
    """alpha-beta ring model for cross-checking the simulated estimate."""
    return 2 * (axis - 1) / axis * bytes_per_chip / (2 * link_MBps * 1e6)
