"""Auto-maintained architecture config (assigned pool).  See base.py."""

from repro_torch.configs.base import ArchConfig, MoESpec  # noqa: F401

"""command-r-plus-104b [dense]: 64L d12288 96H (GQA kv=8) ff33792 v256000."""
CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense", n_layers=64,
    d_model=12288, n_heads=96, n_kv=8, d_ff=33792, vocab=256000,
    head_dim=128, rope_theta=75_000.0,
    notes="GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]")
SMOKE = ArchConfig(
    name="command-r-plus-104b-smoke", family="dense", n_layers=4,
    d_model=96, n_heads=12, n_kv=2, d_ff=192, vocab=512, head_dim=8,
    max_seq=512)
