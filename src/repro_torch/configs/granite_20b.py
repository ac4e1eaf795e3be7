"""Auto-maintained architecture config (assigned pool).  See base.py."""

from repro_torch.configs.base import ArchConfig, MoESpec  # noqa: F401

"""granite-20b [dense]: 52L d6144 48H (MQA kv=1) ff24576 v49152.

IBM Granite 20B code model (arXiv:2405.04324): llama-style blocks with
multi-query attention (single KV head).  MQA means the KV cache cannot be
sharded over heads; the serving path shards it over batch axes instead
(DESIGN.md §4).
"""
CONFIG = ArchConfig(
    name="granite-20b", family="dense", n_layers=52, d_model=6144,
    n_heads=48, n_kv=1, d_ff=24576, vocab=49152, head_dim=128,
    rope_theta=10_000.0,
    notes="llama-arch, code; MQA kv=1 [arXiv:2405.04324; hf]")
SMOKE = ArchConfig(
    name="granite-20b-smoke", family="dense", n_layers=4, d_model=64,
    n_heads=8, n_kv=1, d_ff=128, vocab=256, head_dim=8, max_seq=512)
