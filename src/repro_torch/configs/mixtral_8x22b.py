"""Mixtral-8x22B — 8 experts top-2, SWA [arXiv:2401.04088; hf]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    vocab=32_768,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    d_ff=16_384,
    n_experts=8,
    top_k=2,
    d_expert_ff=16_384,
    act="swiglu",
    norm="rmsnorm",
    source="[arXiv:2401.04088; hf]",
))
