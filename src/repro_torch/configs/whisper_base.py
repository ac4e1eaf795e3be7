"""Auto-maintained architecture config (assigned pool).  See base.py."""

from repro_torch.configs.base import ArchConfig, MoESpec  # noqa: F401

"""whisper-base [audio]: 6L enc + 6L dec, d512 8H ff2048 v51865.

Enc-dec backbone; the conv audio frontend is a stub — input_specs()
supplies precomputed 1500-frame encoder embeddings (B, 1500, d)."""
CONFIG = ArchConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512,
    n_heads=8, n_kv=8, d_ff=2048, vocab=51865, head_dim=64,
    pattern=("cross",), enc_layers=6, enc_frames=1500,
    rope_theta=10_000.0,
    notes="enc-dec, conv frontend stubbed [arXiv:2212.04356]")
SMOKE = ArchConfig(
    name="whisper-base-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv=4, d_ff=128, vocab=256, head_dim=16,
    pattern=("cross",), enc_layers=2, enc_frames=16, max_seq=512)
