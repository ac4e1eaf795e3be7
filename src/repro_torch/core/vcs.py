"""Virtual CXL Switch configurations (paper §II-B, Fig. 3).

A physical CXL switch can present as:

  * a **Single VCS** — one upstream port (USP), N downstream ports (DSP),
    connected by virtual PCI-to-PCI bridges (vPPB): PCIe-compatible, behaves
    like a PCIe switch with CXL link/transaction layers;
  * a **Multiple VCS** — several USPs, each exposing its own Single-VCS view;
    the DSP->USP *binding* is dynamic and even software-composable during
    execution, and one physical DSP can expose multiple **logical devices**
    (resource pooling) bound to different USPs;
  * a **PBR fabric switch** — edge ports with 12-bit port IDs, non-tree
    topologies, true peer-to-peer (modeled by `core.topology` directly).

This module models the first two on top of the interconnect layer: a VCS
compiles down to a Topology fragment whose connectivity *is* the current
binding table, so rebinding = rebuilding routes (exactly how ESF's switch
rebuilds its routing table from interconnect-layer data).  The binding/pool
invariants (a logical device serves exactly one USP at a time; rebinding
moves capacity without physical re-cabling) are property-tested.

The PyTorch port's copy of ``repro.core.vcs`` (plain Python and numpy): it
lowers onto the port's `Topology`, so a VCS's workload runs on the port's
engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .link_layer import FlitConfig
from .topology import (MEMORY, REQUESTER, SWITCH, EndpointSpec, LinkSpec,
                       Topology)


@dataclass
class LogicalDevice:
    """A slice of a physical device under a DSP (resource pooling)."""

    phys_id: int
    fraction: float = 1.0
    bound_usp: int | None = None


@dataclass
class MultiVCS:
    """A multi-USP virtual switch over one physical switch.

    hosts: node descriptors for each USP's root port (requesters).
    devices: physical memory devices under the DSPs; each may be split into
    logical devices bound to different USPs.
    """

    n_usp: int
    n_logical_per_device: int = 1
    bw_MBps: int = 64_000
    fixed_ps: int = 26_000
    devices: int = 4
    pool: list[LogicalDevice] = field(default_factory=list)
    # link layer of every vPPB link (host<->USP and DSP<->device): a
    # FlitConfig / mode string moves the whole VCS between CXL 2.0 (68 B
    # flits) and CXL 3.x (256 B flits); None keeps byte-exact seed semantics.
    # Reliability rides along: a FlitConfig(reliability="stochastic") makes
    # every vPPB link sample seeded per-flit replays + retraining stalls
    # (each channel gets its own substream, so one seed covers the fabric)
    flit: FlitConfig | str | None = None

    def __post_init__(self):
        if not self.pool:
            self.pool = [
                LogicalDevice(phys_id=d, fraction=1.0 / self.n_logical_per_device)
                for d in range(self.devices)
                for _ in range(self.n_logical_per_device)
            ]
            # default: round-robin binding across USPs
            for i, ld in enumerate(self.pool):
                ld.bound_usp = i % self.n_usp

    # ------------------------------------------------------------------
    def bind(self, logical_idx: int, usp: int) -> None:
        """Dynamic DSP->USP (re)binding — software-composed, no re-cabling."""
        if not 0 <= usp < self.n_usp:
            raise ValueError(f"usp {usp} out of range")
        self.pool[logical_idx].bound_usp = usp

    def visible_capacity(self, usp: int) -> float:
        """Memory capacity fraction currently visible to a USP."""
        return sum(ld.fraction for ld in self.pool if ld.bound_usp == usp)

    def check_invariants(self) -> None:
        for ld in self.pool:
            assert ld.bound_usp is None or 0 <= ld.bound_usp < self.n_usp
        # one physical device's logical slices never exceed the device
        by_phys: dict[int, float] = {}
        for ld in self.pool:
            by_phys[ld.phys_id] = by_phys.get(ld.phys_id, 0.0) + ld.fraction
        assert all(f <= 1.0 + 1e-9 for f in by_phys.values())

    # ------------------------------------------------------------------
    def build_topology(self) -> tuple[Topology, dict]:
        """Materialize the current binding as a Topology.

        Each USP's Single-VCS view is one switch node; a logical device
        attaches to the switch of the USP it is bound to, with bandwidth
        scaled by its pooling fraction (the paper's resource-isolation
        semantics).  Unbound logical devices are not reachable.
        """
        self.check_invariants()
        kinds: list[int] = []
        links: list[LinkSpec] = []

        def add(kind):
            kinds.append(kind)
            return len(kinds) - 1

        hosts = [add(REQUESTER) for _ in range(self.n_usp)]
        vcs = [add(SWITCH) for _ in range(self.n_usp)]
        for h, s in zip(hosts, vcs):
            links.append(LinkSpec(h, s, self.bw_MBps, self.fixed_ps,
                                  flit=self.flit))
        mapping = {"hosts": hosts, "vcs": vcs, "logical": []}
        for ld in self.pool:
            if ld.bound_usp is None:
                mapping["logical"].append(None)
                continue
            m = add(MEMORY)
            mapping["logical"].append(m)
            links.append(LinkSpec(
                vcs[ld.bound_usp], m,
                max(int(self.bw_MBps * ld.fraction), 1), self.fixed_ps,
                flit=self.flit))
        topo = Topology(np.asarray(kinds, np.int64), links, name="multi-vcs",
                        endpoint=EndpointSpec())
        return topo, mapping
