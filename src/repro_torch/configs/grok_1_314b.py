"""Auto-maintained architecture config (assigned pool).  See base.py."""

from repro_torch.configs.base import ArchConfig, MoESpec  # noqa: F401

"""grok-1-314b [moe]: 64L d6144 48H (GQA kv=8) ff32768, 8 experts top-2,
v131072.

8 experts do not divide the 16-way model axis, so experts replicate on
the expert dim and the expert FFN is tensor-parallel over 'model'
(DESIGN.md §Arch-applicability / moe_axes('ffn'))."""
CONFIG = ArchConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv=8, d_ff=32768, vocab=131072, head_dim=128,
    pattern=("attn_moe",), moe=MoESpec(n_experts=8, top_k=2),
    rope_theta=10_000.0,
    notes="8 experts top-2 [hf:xai-org/grok-1]")
SMOKE = ArchConfig(
    name="grok-1-314b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, d_ff=128, vocab=256, head_dim=16,
    pattern=("attn_moe",),
    moe=MoESpec(n_experts=4, top_k=2, capacity_factor=8.0), max_seq=512)
