"""Mamba2-2.7B — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    vocab=50_280,
    ssm_state=128,
    ssm_expand=2,               # d_inner = 5120, 80 heads of 64
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
    norm="rmsnorm",
    source="[arXiv:2405.21060; unverified]",
))
