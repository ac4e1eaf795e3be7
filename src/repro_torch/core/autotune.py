"""Fabric-aware sharding autotuner (beyond-paper application of ESF), on
the port: the counterpart of ``repro.core.autotune``.

Enumerates candidate parallel layouts for a transformer stack on the
production mesh, scores each with a three-term roofline (compute / HBM /
collectives) where the collective term comes from the ESF fabric engine
(`core.fabric_model`) rather than a closed-form alpha-beta guess, and ranks
them.  This is the paper's "simulate the interconnect to design the system"
loop pointed at our own framework; the §Perf hillclimbs use it to pick
candidates before re-lowering.

The mesh scored here is the *simulated* TPU pod of `core.fabric_model`:
its peak rate, HBM rate, link rates and the 16 GB HBM capacity are that
pod's parameters.  With ``use_engine=True`` every collective term is one
schedule resolved on ``device`` (the card unless the caller asks for the
CPU); the float expressions keep the reference's order, so every `Score`
field equals the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .fabric_model import (
    TPUFabric, V5E_DCN_MBPS, V5E_HBM_BPS, V5E_ICI_MBPS, V5E_PEAK_FLOPS,
    analytic_ring_seconds, predict_collective,
)


@dataclass(frozen=True)
class WorkloadDims:
    """Per-step model/workload dimensions (training unless decode=True)."""

    n_layers: int
    d_model: int
    d_ff: int
    n_heads: int
    n_kv: int
    head_dim: int
    vocab: int
    batch: int
    seq: int
    n_experts: int = 0
    top_k: int = 0
    decode: bool = False

    @property
    def layer_params(self) -> int:
        att = self.d_model * (self.n_heads + 2 * self.n_kv) * self.head_dim \
            + self.n_heads * self.head_dim * self.d_model
        ff = 3 * self.d_model * self.d_ff
        if self.n_experts:
            ff *= self.n_experts
        return att + ff

    @property
    def params(self) -> int:
        return self.n_layers * self.layer_params + self.vocab * self.d_model

    @property
    def active_params(self) -> int:
        att = self.d_model * (self.n_heads + 2 * self.n_kv) * self.head_dim \
            + self.n_heads * self.head_dim * self.d_model
        ff = 3 * self.d_model * self.d_ff * (self.top_k or 1) \
            * (1 if self.n_experts else 1)
        return self.n_layers * (att + ff) + self.vocab * self.d_model


@dataclass(frozen=True)
class Layout:
    """One candidate distribution layout on the (pod, data, model) mesh."""

    name: str
    batch_over: tuple[str, ...] = ("pod", "data")
    fsdp: bool = True              # shard params over 'data' + gather per layer
    tp: bool = True                # shard heads/mlp over 'model'
    seq_shard: bool = False        # sequence parallelism for activations
    zero_pod: bool = True          # optimizer state sharded across pods


DEFAULT_CANDIDATES = (
    Layout("fsdp+tp", fsdp=True, tp=True),
    Layout("fsdp-only", fsdp=True, tp=False),
    Layout("tp-only", fsdp=False, tp=True),
    Layout("fsdp+tp+sp", fsdp=True, tp=True, seq_shard=True),
    Layout("ddp", fsdp=False, tp=False),
)


@dataclass
class Score:
    layout: Layout
    compute_s: float
    memory_s: float
    collective_s: float
    step_s: float
    hbm_bytes_per_chip: float
    detail: dict = field(default_factory=dict)

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


def score_layout(dims: WorkloadDims, layout: Layout, fabric: TPUFabric,
                 graph=None, use_engine: bool = False, device="cuda",
                 simulate_fn=None) -> Score:
    """Roofline-score one layout.  With use_engine=True the collective term is
    simulated on the fabric graph (exact contention); otherwise the analytic
    ring model is used (fast path for wide sweeps)."""
    chips = fabric.pods * fabric.nx * fabric.ny
    data_ax, model_ax = fabric.nx, fabric.ny
    dp = fabric.pods * data_ax if "pod" in layout.batch_over else data_ax
    tp = model_ax if layout.tp else 1

    # ---- compute: 6ND for train, 2ND for decode ----
    flops = (2 if dims.decode else 6) * dims.active_params * dims.batch * dims.seq
    if dims.decode:
        flops = 2 * dims.active_params * dims.batch  # one token per sequence
    compute_s = flops / (chips * V5E_PEAK_FLOPS)

    # ---- memory: weights + activations traffic per chip ----
    shard = (dp if layout.fsdp else 1) * tp
    wbytes = 2 * dims.params / shard
    passes = 1 if dims.decode else 3  # fwd + bwd(2x) weight reads
    act = 2 * dims.batch * dims.seq * dims.d_model * dims.n_layers / max(dp, 1) \
        / (tp if layout.seq_shard else 1)
    kv = (2 * dims.batch * dims.seq * dims.n_kv * dims.head_dim * 2
          * dims.n_layers / max(dp, 1) / max(tp if dims.n_kv >= tp else 1, 1)
          if dims.decode else 0)
    hbm = passes * wbytes + 4 * act + kv
    memory_s = hbm / V5E_HBM_BPS

    # ---- collectives ----
    coll_s = 0.0
    detail = {}

    def ring(nbytes, axis, kind="all_reduce"):
        if use_engine and graph is not None:
            return predict_collective(fabric, graph, kind, axis, int(nbytes),
                                      device, simulate_fn).seconds
        ax = fabric.nx if axis == "x" else fabric.ny
        t = analytic_ring_seconds(int(nbytes), ax)
        return t if kind == "all_reduce" else t / 2

    if layout.fsdp and not dims.decode:
        # per-layer param all-gather (fwd+bwd) + grad reduce-scatter over data
        per_layer = 2 * dims.layer_params / tp
        t = (2 * ring(per_layer, "x", "all_gather")
             + ring(per_layer, "x", "reduce_scatter")) * dims.n_layers
        coll_s += t
        detail["fsdp"] = t
    if not layout.fsdp and not dims.decode:
        t = ring(2 * dims.params / tp, "x", "all_reduce")
        coll_s += t
        detail["grad_allreduce"] = t
    if layout.tp:
        # 2 activation all-reduces per layer over 'model'
        act_bytes = 2 * dims.batch * dims.seq * dims.d_model / max(dp, 1)
        if dims.decode:
            act_bytes = 2 * dims.batch * dims.d_model / max(dp, 1)
        t = 2 * dims.n_layers * ring(act_bytes, "y")
        if layout.seq_shard:
            t *= 0.6  # RS+AG replaces 2xAR on the sharded dimension
        coll_s += t
        detail["tp"] = t
    if dims.n_experts and layout.tp:
        a2a = 2 * dims.batch * dims.seq * dims.d_model * dims.top_k / max(dp, 1)
        if use_engine and graph is not None:
            t = 2 * dims.n_layers * predict_collective(
                fabric, graph, "all_to_all", "y", int(a2a), device,
                simulate_fn).seconds
        else:
            t = 2 * dims.n_layers * a2a / (V5E_ICI_MBPS * 1e6 * 4)
        coll_s += t
        detail["moe_a2a"] = t
    if fabric.pods > 1 and "pod" in layout.batch_over and not dims.decode:
        g = 2 * dims.params / (data_ax * tp)
        t = g / (V5E_DCN_MBPS * 1e6)
        coll_s += t
        detail["dcn_grad"] = t

    # HBM residency check (params+opt+grads, bf16 + f32 m/v/master)
    state_bytes = dims.params * (2 + 12 / (chips / shard if layout.zero_pod else shard)) / shard

    step = max(compute_s, memory_s) + coll_s  # collectives partly exposed
    return Score(layout, compute_s, memory_s, coll_s, step,
                 hbm_bytes_per_chip=state_bytes, detail=detail)


def autotune(dims: WorkloadDims, fabric: TPUFabric,
             candidates=DEFAULT_CANDIDATES, graph=None,
             use_engine: bool = False, hbm_cap: float = 16e9,
             device="cuda", simulate_fn=None) -> list[Score]:
    """Rank layouts; layouts whose state can't fit HBM are filtered."""
    scored = [score_layout(dims, c, fabric, graph, use_engine, device,
                           simulate_fn)
              for c in candidates]
    feasible = [s for s in scored if s.hbm_bytes_per_chip < hbm_cap * 0.9]
    return sorted(feasible or scored, key=lambda s: s.step_s)
