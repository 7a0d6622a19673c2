"""Qwen2-VL-72B — M-RoPE, dynamic resolution (vision frontend stubbed)
[arXiv:2409.12191; hf]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    vocab=152_064,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    rope_theta=1_000_000.0,
    attn_bias=True,
    mrope_sections=(16, 24, 24),
    d_ff=29_568,
    act="swiglu",
    norm="rmsnorm",
    source="[arXiv:2409.12191; hf]",
))
