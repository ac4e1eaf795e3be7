"""Auto-maintained architecture config (assigned pool).  See base.py."""

from repro_torch.configs.base import ArchConfig, MoESpec  # noqa: F401

"""qwen3-moe-30b-a3b [moe]: 48L d2048 32H (GQA kv=4) per-expert ff768,
128 experts top-8, v151936."""
CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv=4, d_ff=768, vocab=151936, head_dim=128,
    pattern=("attn_moe",), moe=MoESpec(n_experts=128, top_k=8),
    rope_theta=1_000_000.0,
    notes="128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]")
SMOKE = ArchConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, d_ff=32, vocab=256, head_dim=16,
    pattern=("attn_moe",),
    # dropless capacity in the smoke config: capacity dropping is batch-
    # global (non-causal), so train/serve consistency checks need cf high
    moe=MoESpec(n_experts=8, top_k=2, capacity_factor=8.0), max_seq=512)
