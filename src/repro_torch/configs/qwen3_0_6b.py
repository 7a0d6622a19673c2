"""Qwen3-0.6B — qk_norm, GQA [hf:Qwen/Qwen3-8B family; hf]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    vocab=151_936,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    rope_theta=1_000_000.0,
    qk_norm=True,
    d_ff=3072,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    source="[hf:Qwen/Qwen3-0.6B; hf]",
))
