"""Zamba2-7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242; unverified]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    vocab=32_000,
    ssm_state=64,
    ssm_expand=2,               # d_inner = 7168, 112 heads of 64
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
    attn_every=6,               # 13 shared-attn applications + 3 tail layers
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    rope_theta=10_000.0,
    d_ff=14_336,
    act="swiglu",
    norm="rmsnorm",
    source="[arXiv:2411.15242; unverified]",
))
