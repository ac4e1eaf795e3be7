"""Auto-maintained architecture config (assigned pool).  See base.py."""

from repro_torch.configs.base import ArchConfig, MoESpec  # noqa: F401

"""llama3-8b [dense]: 32L d4096 32H (GQA kv=8) ff14336 v128256."""
CONFIG = ArchConfig(
    name="llama3-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=14336, vocab=128256, head_dim=128,
    rope_theta=500_000.0,
    notes="GQA, 128k vocab [arXiv:2407.21783]")
SMOKE = ArchConfig(
    name="llama3-8b-smoke", family="dense", n_layers=4, d_model=64,
    n_heads=8, n_kv=2, d_ff=160, vocab=512, head_dim=8, max_seq=512,
    rope_theta=500_000.0)
