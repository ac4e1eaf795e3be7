"""Auto-maintained architecture config (assigned pool).  See base.py."""

from repro_torch.configs.base import ArchConfig, MoESpec  # noqa: F401

"""phi3-mini-3.8b [dense]: 32L d3072 32H (kv=32, MHA) ff8192 v32064."""
CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv=32, d_ff=8192, vocab=32064, head_dim=96,
    rope_theta=10_000.0,
    notes="RoPE SwiGLU, kv=heads [arXiv:2404.14219]")
SMOKE = ArchConfig(
    name="phi3-mini-3.8b-smoke", family="dense", n_layers=3, d_model=48,
    n_heads=4, n_kv=4, d_ff=96, vocab=256, head_dim=12, max_seq=512)
