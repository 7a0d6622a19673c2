"""Minitron-4B — pruned Nemotron, squared-ReLU MLP [arXiv:2407.14679; hf]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    vocab=256_000,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    rope_theta=10_000.0,
    d_ff=9216,
    act="relu2",
    norm="rmsnorm",
    source="[arXiv:2407.14679; hf]",
))
