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
    M-RoPE positions with the reference's image span (``api.synth_batch``);
    Whisper's standard-normal audio frames, drawn after the tokens."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    out = {"tokens": tokens}
    if kind == "train":
        out["labels"] = np.roll(tokens, -1, axis=1)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        span = (8, 8 + min(16, s // 2)) if s >= 24 else None
        out["positions"] = np.asarray(jfrontends.mrope_positions(
            cfg, b, s, image_span=span, grid=(4, 4)))
    return out


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def prefix(batch: dict, n: int) -> dict:
    """The prompt of a batch: its first ``n`` tokens (and positions), no
    labels; frames whole."""
    return {k: (v[..., :n] if k in ("tokens", "positions") else v)
            for k, v in batch.items() if k != "labels"}


def loss_and_grads(params, batch, cfg):
    """The port's ``api.loss_fn`` and its gradients, in ``leaves`` order."""
    import torch
    from repro_torch.models import api
    from repro_torch.optim._tree import leaves

    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss = api.loss_fn(params, batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, flat)


def reference_grads(jp, batch, jcfg):
    """The reference's loss and gradients (jitted), with each leaf's path."""
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: japi.loss_fn(p, b, jcfg)))(
        jp, to_jax(batch))
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return (float(loss), [jax.tree_util.keystr(k) for k, _ in flat],
            [np.asarray(g) for _, g in flat])


# A key bias adds the same q·b_k to every score of a query, which the
# softmax cancels: its exact gradient is 0, and both sides return rounding
# noise (~1e-10 at smoke sizes), so it is held absolutely, against the
# largest gradient of the tree, and not relative to its own noise.
ZERO_GRAD_LEAVES = ("['bk']",)


def assert_grads_match(got, want, paths) -> None:
    """Gradients leaf for leaf within ``GRAD_TOL`` of each leaf's max|want|
    (the key biases within ``GRAD_TOL`` of the tree's max|want|)."""
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    top = max(float(np.abs(w).max()) for w in want)
    for g, w, path in zip(got, want, paths):
        if path.endswith(ZERO_GRAD_LEAVES):
            assert float(np.abs(g.float().numpy() - w).max()) <= GRAD_TOL * top, path
        else:
            assert rel_err(g, w) <= GRAD_TOL, path


def reference_greedy(jp, batch, jcfg, s_max: int, gen: int):
    """The reference launcher's greedy loop (jitted): prefill ``batch``, then
    ``gen`` decode steps; the ids (B, gen) and the logits each id was taken
    from."""
    prefill = jax.jit(lambda p, b: japi.prefill(p, b, jcfg, s_max=s_max))
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jcfg))
    logits, cache = prefill(jp, to_jax(batch))
    steps, ids = [], []
    for _ in range(gen):
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        ids.append(np.asarray(tok))
        logits, cache = decode(jp, cache, tok)
    return np.concatenate(ids, axis=1), steps


def assert_tree_close(got, want) -> None:
    """A cache of the port against the reference's, leaf for leaf: the same
    structure (None where the reference has None), ``len`` equal, every
    tensor within ``TOL`` of its max|want|."""
    from repro_torch.optim._tree import leaves

    want_l, got_l = jax.tree.leaves(want), leaves(got)
    assert len(got_l) == len(want_l)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, want))
    for g, w in zip(got_l, want_l):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.ndim == 0:
            assert int(g) == int(w)
        else:
            assert str(g.dtype)[6:] == str(w.dtype)
            assert rel_err(g, w) <= TOL
