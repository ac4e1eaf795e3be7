"""ESF core, PyTorch port: interconnect layer + device layer + exact engine.

Mirrors ``repro.core`` for what this slice of the port has.  Importing it
imports torch and numpy only — never JAX, never the ``repro`` package.
"""

from . import calibration, convert, devices, engine, link_layer  # noqa: F401
from . import ref_des, topology, verify  # noqa: F401
from .topology import (  # noqa: F401
    REQUESTER, SWITCH, MEMORY,
    Topology, LinkSpec, EndpointSpec, FabricGraph,
    chain, tree, ring, spine_leaf, fully_connected, single_bus, with_flit,
    TOPOLOGY_BUILDERS,
)
from .link_layer import (  # noqa: F401
    FlitConfig, FLIT_MODES, PCIE5_FLIT, PCIE6_FLIT,
    flit_efficiency, goodput_efficiency, replay_overhead_ppm,
    credit_limited_MBps,
)
from .engine import (  # noqa: F401
    Channels, Hops, Schedule, SimOptions, StreamCarry, simulate,
    simulate_auto, channel_stats, request_stats, make_channels, ser_ps,
    empty_carry, round_bound, replay_round, simulate_stacked, stack_members,
    member, stacked_request_stats, stacked_channel_stats,
)
from .devices import RequesterSpec, Workload, build_workload  # noqa: F401
from .verify import (  # noqa: F401
    Finding, VerifyError, VerifyReport, assert_valid, join_depth,
    verify_built, verify_workload,
)
from .ref_des import ref_schedule, simulate_ref  # noqa: F401
from .convert import (  # noqa: F401
    carry_from_arrays, channels_from_arrays, hops_from_arrays,
    issue_from_array, schedule_to_numpy,
)

__all__ = [
    # topology / link layer
    "REQUESTER", "SWITCH", "MEMORY", "Topology", "LinkSpec", "EndpointSpec",
    "FabricGraph", "chain", "tree", "ring", "spine_leaf", "fully_connected",
    "single_bus", "with_flit", "TOPOLOGY_BUILDERS", "FlitConfig",
    "FLIT_MODES", "PCIE5_FLIT", "PCIE6_FLIT", "flit_efficiency",
    "goodput_efficiency", "replay_overhead_ppm", "credit_limited_MBps",
    # schedule engine
    "Channels", "Hops", "Schedule", "SimOptions", "StreamCarry", "simulate",
    "simulate_auto", "round_bound", "channel_stats", "request_stats",
    "make_channels", "ser_ps", "empty_carry", "replay_round",
    # stacked sweeps (the counterpart of jax.vmap(simulate))
    "simulate_stacked", "stack_members", "member", "stacked_request_stats",
    "stacked_channel_stats",
    # device layer
    "RequesterSpec", "Workload", "build_workload",
    # oracle / verification
    "join_depth", "simulate_ref", "ref_schedule", "Finding", "VerifyError",
    "VerifyReport", "verify_workload", "assert_valid", "verify_built",
    # moving lowered state between the reference and the port
    "hops_from_arrays", "channels_from_arrays", "carry_from_arrays",
    "issue_from_array", "schedule_to_numpy",
    # submodules
    "topology", "engine", "devices", "link_layer", "calibration", "verify",
    "ref_des", "convert",
]
