"""Qwen1.5-MoE-A2.7B — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    vocab=151_936,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    rope_theta=1_000_000.0,
    attn_bias=True,
    d_ff=1408,                      # routed-expert ff (spec: d_ff=1408)
    n_experts=60,
    top_k=4,
    d_expert_ff=1408,
    n_shared_experts=4,             # shared expert = 4 × 1408 = 5632
    act="swiglu",
    norm="rmsnorm",
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
))
