"""Shared helpers of the model-zoo parity tests: carry the JAX package's
parameters and inputs to the port, and compare outputs relative to the
reference's largest magnitude.

Both sides run f32 products on the CPU in their own summation orders, so
the comparisons take a tolerance relative to max|want| (the differences
read ~1e-6 at smoke sizes), never bits; verdicts that must be exact (remat,
reruns) compare the port with itself.
"""
import numpy as np

import jax_reference  # noqa: F401  (before any repro import)
import jax
import jax.numpy as jnp
from repro.models import api as japi
from repro.models import frontends as jfrontends

from repro_torch.models import params_from_reference

# forward logits, losses and prefill/decode logits of the two packages, relative
# to max|want|: ten times the ~1e-6 the CPU products' orders leave at smoke
# sizes, and ~100 times under a bf16 or TF32 product
TOL = 1e-5
# gradients, relative to each leaf's max|want|: backward chains add a few more
# roundings (up to 2.3e-6 read)
GRAD_TOL = 2e-5


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def to_port(tree):
    """A reference tree (parameters, a batch, a cache) as the port's, on the CPU."""
    return params_from_reference(to_numpy(tree), device="cpu")


def rel_err(got, want) -> float:
    got = got.detach().float().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def ref_params(cfg, seed: int):
    return japi.init(jax.random.key(seed), cfg)


def batch_np(cfg, b: int, s: int, seed: int, kind: str = "train") -> dict:
    """Tokens from numpy's ``default_rng(seed)``; labels the next token; a VLM's
    M-RoPE positions with the reference's image span (``api.synth_batch``)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    out = {"tokens": tokens}
    if kind == "train":
        out["labels"] = np.roll(tokens, -1, axis=1)
    if cfg.family == "vlm":
        span = (8, 8 + min(16, s // 2)) if s >= 24 else None
        out["positions"] = np.asarray(jfrontends.mrope_positions(
            cfg, b, s, image_span=span, grid=(4, 4)))
    return out


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}
