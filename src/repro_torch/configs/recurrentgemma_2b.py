"""Auto-maintained architecture config (assigned pool).  See base.py."""

from repro_torch.configs.base import ArchConfig, MoESpec  # noqa: F401

"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1) ff7680 v256000.

Griffin pattern: (RG-LRU, RG-LRU, local attention) repeating, window 2048
— 26 layers = 8 full periods + a 2-block recurrent tail.  Sub-quadratic:
the long_500k cell runs (DESIGN.md §Arch-applicability).
"""
CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv=1, d_ff=7680, vocab=256000, head_dim=256,
    pattern=("rglru", "rglru", "attn_local"), window=2048,
    sub_quadratic=True, rope_theta=10_000.0,
    notes="RG-LRU + local attn 1:2 [arXiv:2402.19427; hf]")
SMOKE = ArchConfig(
    name="recurrentgemma-2b-smoke", family="hybrid", n_layers=5,
    d_model=64, n_heads=4, n_kv=1, d_ff=128, vocab=256, head_dim=16,
    pattern=("rglru", "rglru", "attn_local"), window=32,
    sub_quadratic=True, max_seq=512)
