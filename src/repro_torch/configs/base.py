"""Architecture configuration schema + input-shape registry (the port's copy).

A copy of ``repro/configs/base.py``, kept here because the port imports
nothing of the JAX package: every architecture is a module in
`repro_torch.configs` exposing ``CONFIG`` (an ArchConfig with the exact
published dimensions) and ``SMOKE`` (the reduced same-family config the CPU
tests use).  The port's model stack builds every block kind of the
pattern (`repro_torch.models.transformer`).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | hybrid | moe | audio | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # block pattern, repeated over the stack: entries from
    #   attn | attn_local | attn_moe | rglru | ssd | cross
    pattern: tuple[str, ...] = ("attn",)
    window: int = 4096          # sliding window for attn_local
    moe: MoESpec | None = None
    # ssm (mamba2)
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_state: int = 0
    # enc-dec (whisper): encoder layers + stub frontend length
    enc_layers: int = 0
    enc_frames: int = 1500
    # vlm stub frontend: number of patch embeddings prepended
    vision_patches: int = 0
    rope_theta: float = 10_000.0
    causal: bool = True
    # perf knobs (hillclimb targets; see EXPERIMENTS.md §Perf)
    ssd_chunk: int = 128
    moe_group: int = 512
    attn_chunk: int = 1024
    max_seq: int = 524_288
    tie_embeddings: bool = True
    sub_quadratic: bool = False  # True -> long_500k decode is runnable
    notes: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    def params_count(self) -> int:
        att = self.d_model * (self.n_heads + 2 * self.n_kv) * self.head_dim \
            + self.n_heads * self.head_dim * self.d_model
        per_layer = {
            "attn": att + 3 * self.d_model * self.d_ff,
            "attn_local": att + 3 * self.d_model * self.d_ff,
            "cross": 2 * att + 3 * self.d_model * self.d_ff,
            "attn_moe": att + (3 * self.d_model * self.d_ff
                               * (self.moe.n_experts if self.moe else 1))
            + self.d_model * (self.moe.n_experts if self.moe else 0),
            "rglru": 5 * self.d_model * self.d_model
            + 3 * self.d_model * self.d_ff,
            "ssd": self.d_model * (2 * self.ssm_heads * self.ssm_head_dim * 2
                                   + 2 * self.ssm_state + self.ssm_heads),
        }
        total = 0
        for i in range(self.n_layers):
            total += per_layer[self.pattern[i % len(self.pattern)]]
        total += self.enc_layers * (att + 3 * self.d_model * self.d_ff)
        total += self.vocab * self.d_model
        return total

    def active_params_count(self) -> int:
        if not self.moe:
            return self.params_count()
        dense = replace(self, moe=MoESpec(1, 1),
                        pattern=tuple("attn" if p == "attn_moe" else p
                                      for p in self.pattern))
        att_moe_layers = sum(1 for i in range(self.n_layers)
                             if self.pattern[i % len(self.pattern)] == "attn_moe")
        return dense.params_count() + att_moe_layers * 3 * self.d_model \
            * self.d_ff * (self.moe.top_k - 1)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode | long_decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "long_decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs; reason recorded in DESIGN.md."""
    if shape.kind == "long_decode" and not cfg.sub_quadratic:
        return False, ("pure full-attention architecture: 512k dense decode "
                       "is O(S^2)/token with no sub-quadratic path")
    return True, ""
