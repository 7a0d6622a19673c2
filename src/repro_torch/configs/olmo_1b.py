"""OLMo-1B — non-parametric LN [arXiv:2402.00838; hf]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    vocab=50_304,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    rope_theta=10_000.0,
    d_ff=8192,
    act="swiglu",
    norm="ln_nonparam",
    tie_embeddings=True,
    source="[arXiv:2402.00838; hf]",
))
