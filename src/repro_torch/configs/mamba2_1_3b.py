"""Auto-maintained architecture config (assigned pool).  See base.py."""

from repro_torch.configs.base import ArchConfig, MoESpec  # noqa: F401

"""mamba2-1.3b [ssm]: 48L d2048 attention-free, SSD state 128, v50280.

d_inner = 2*d_model = 4096 = 64 heads x 64 head_dim.  Sub-quadratic:
long_500k runs with O(1) decode state."""
CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=1, n_kv=1, d_ff=0, vocab=50280, head_dim=64,
    pattern=("ssd",), ssm_heads=64, ssm_head_dim=64, ssm_state=128,
    sub_quadratic=True,
    notes="SSD state-space duality [arXiv:2405.21060]")
SMOKE = ArchConfig(
    name="mamba2-1.3b-smoke", family="ssm", n_layers=3, d_model=64,
    n_heads=1, n_kv=1, d_ff=0, vocab=256, head_dim=16, pattern=("ssd",),
    ssm_heads=4, ssm_head_dim=16, ssm_state=16, sub_quadratic=True,
    max_seq=512)
