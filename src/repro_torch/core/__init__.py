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
from . import routing, traces, vcs  # noqa: F401
from .traces import (  # noqa: F401
    ARRIVAL_PATTERNS, WORKLOADS, arrival_times, request_stream, tenant_mix,
)
from .routing import route_and_simulate, STRATEGIES  # noqa: F401
from . import coherence_traffic, snoop_filter  # noqa: F401
from .snoop_filter import (  # noqa: F401
    POLICIES, SFConfig, CacheConfig, SFEvents, SFResult, SFState,
    owner_count, sf_init_state, simulate_sf, simulate_sf_many,
    make_skewed_stream, make_sequential_stream,
)
from .coherence_traffic import (  # noqa: F401
    CoherenceFabricSpec, CoherenceLowering, CoherenceStream, CoupledResult,
    FANOUT_MODES, LEG_NAMES, bisnp_latencies, coherence_issue,
    concat_background, hop_legs, leg_blame, lower_coherence, pad_rows,
    simulate_coupled,
)
from . import telemetry  # noqa: F401
from .telemetry import (  # noqa: F401
    LatencyAttribution, ChannelTelemetry, ChannelBlame, WindowedSeries,
    QuantileSketch, SFTelemetry, attribute_latency, conservation_residual,
    channel_telemetry, channel_blame, blame_conservation_residual,
    windowed_series, sketch_new, sketch_update, sketch_merge,
    sketch_quantile, sketch_quantiles, sf_telemetry, fabric_metrics,
    StreamTelemetry, stream_telemetry_new, stream_telemetry_fold,
    stream_telemetry_finalize,
)
from . import critical_path, trace_export  # noqa: F401
from .critical_path import (  # noqa: F401
    KIND_NAMES, Backpointers, Blame, PathEdge, blame, critical_path as
    extract_critical_path, critical_paths, extract_backpointers, path_total,
    speedup_if,
)
from .trace_export import (  # noqa: F401
    channel_names, schedule_trace, coupled_trace, validate_trace, write_trace,
)
from . import streaming  # noqa: F401
from .streaming import (  # noqa: F401
    StreamResult, StreamState, simulate_stream, stream_windows,
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
    # device layer / workloads / traces
    "RequesterSpec", "Workload", "build_workload", "ARRIVAL_PATTERNS",
    "WORKLOADS", "arrival_times", "request_stream", "tenant_mix",
    # routing
    "route_and_simulate", "STRATEGIES",
    # device coherence: the snoop filter and its fabric coupling
    "POLICIES", "SFConfig", "CacheConfig", "SFEvents", "SFResult", "SFState",
    "owner_count", "sf_init_state", "simulate_sf", "simulate_sf_many",
    "make_skewed_stream", "make_sequential_stream", "CoherenceFabricSpec",
    "CoherenceLowering", "CoherenceStream", "CoupledResult", "FANOUT_MODES",
    "LEG_NAMES", "bisnp_latencies", "coherence_issue", "concat_background",
    "hop_legs", "leg_blame", "lower_coherence", "pad_rows",
    "simulate_coupled",
    # telemetry: attribution, channel counters and blame, series, sketches
    "LatencyAttribution", "ChannelTelemetry", "ChannelBlame",
    "WindowedSeries", "QuantileSketch", "SFTelemetry", "attribute_latency",
    "conservation_residual", "channel_telemetry", "channel_blame",
    "blame_conservation_residual", "windowed_series", "sketch_new",
    "sketch_update", "sketch_merge", "sketch_quantile", "sketch_quantiles",
    "sf_telemetry", "fabric_metrics", "StreamTelemetry",
    "stream_telemetry_new", "stream_telemetry_fold",
    "stream_telemetry_finalize",
    # critical paths, blame and what-ifs; the Perfetto trace export
    "KIND_NAMES", "Backpointers", "Blame", "PathEdge", "blame",
    "extract_critical_path", "critical_paths", "extract_backpointers",
    "path_total", "speedup_if", "channel_names", "schedule_trace",
    "coupled_trace", "validate_trace", "write_trace",
    # streaming windowed simulation
    "StreamState", "StreamResult", "simulate_stream", "stream_windows",
    # oracle / verification
    "join_depth", "simulate_ref", "ref_schedule", "Finding", "VerifyError",
    "VerifyReport", "verify_workload", "assert_valid", "verify_built",
    # moving lowered state between the reference and the port
    "hops_from_arrays", "channels_from_arrays", "carry_from_arrays",
    "issue_from_array", "schedule_to_numpy",
    # submodules
    "topology", "engine", "devices", "link_layer", "calibration", "verify",
    "ref_des", "convert", "traces", "routing", "vcs", "snoop_filter",
    "coherence_traffic", "telemetry", "critical_path", "trace_export",
    "streaming",
]
