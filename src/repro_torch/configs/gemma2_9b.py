"""Gemma2-9B — local+global alternating, logit softcap [arXiv:2408.00118; hf]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    vocab=256_000,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    rope_theta=10_000.0,
    sliding_window=4096,
    local_global=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    d_ff=14_336,
    act="geglu",
    norm="rmsnorm_offset",
    post_norms=True,
    tie_embeddings=True,
    source="[arXiv:2408.00118; hf]",
))
