"""Auto-maintained architecture config (assigned pool).  See base.py."""

from repro_torch.configs.base import ArchConfig, MoESpec  # noqa: F401

"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend stub.

32L d3072 32H kv=32 ff8192 v32064; input_specs() supplies 576 projected
patch embeddings (B, 576, d) that replace the prompt prefix."""
CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv=32, d_ff=8192, vocab=32064, head_dim=96,
    vision_patches=576, rope_theta=10_000.0,
    notes="phi3-mini + CLIP stub [hf:microsoft/Phi-3-vision-128k-instruct]")
SMOKE = ArchConfig(
    name="phi-3-vision-4.2b-smoke", family="vlm", n_layers=3, d_model=48,
    n_heads=4, n_kv=4, d_ff=96, vocab=256, head_dim=12,
    vision_patches=8, max_seq=512)
