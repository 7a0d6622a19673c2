"""Whisper-medium — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,                 # decoder
    n_enc_layers=24,
    d_model=1024,
    vocab=51_865,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    act="gelu",
    norm="ln",
    attn_bias=True,
    tie_embeddings=True,
    enc_frames=1500,
    source="[arXiv:2212.04356; unverified]",
))
