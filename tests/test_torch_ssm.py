"""The port's Mamba2 (``repro_torch.models.ssm``) against the JAX package's
on the CPU, at ``smoke()`` sizes (2 layers, d_model 64, 8 heads of 16,
state 16, chunk 16, conv 4).

The reference's parameters are carried across with ``params_from_reference``
and the same numpy inputs go through both sides.  Checked, within
``model_parity.TOL`` (gradients ``GRAD_TOL``): ``_segsum`` (and a gradient
through its masked ``exp``, which must be 0, not NaN), ``_causal_conv``,
``_gated_norm``, ``mamba_chunked`` at a ragged length and with a starting
state, its gradients, ``mamba_step``; the LM's forward, ``loss_fn`` with a
blanking ``loss_weight`` and its gradients leaf for leaf; the prefill caches
at prompts shorter than the conv window (whose tails are shorter, as the
reference's slice makes them) and prefill-then-decode from a prompt as long
as it; greedy ids over 8 steps; the reference's own Mamba2 tests; the bf16
casts (``mamba_chunked``, ``mamba_step`` and one layer at
``smoke(dtype="bfloat16")``, within ``BF16_TOL``); remat bit for bit;
``param_specs`` on the meta device; the bf16 parameter round trip.  The
reference's outputs are computed once per module.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

import model_parity as mp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api, params_to_reference, ssm  # noqa: E402
from repro_torch.optim._tree import leaves  # noqa: E402

ARCH = "mamba2-2.7b"
B, S = 2, 30                              # 30 tokens at chunk 16: two chunks of 15
LOSS_WEIGHT = np.array([1.0, 0.0], np.float32)
GEN, PROMPT = 8, 12
# bf16 against the reference's bf16, relative to max|y|: both round to bf16
# at each op, in places that differ (XLA keeps f32 inside fused elementwise
# chains); a cast left out or added moves y by whole bf16 steps of the
# largest values.  The port's bf16 limit for the model zoo (test_torch_models).
BF16_TOL = 3e-2
# the reference tests' own tolerances (rtol = atol)
STATE_TOL = 2e-3
SERVE_TOL = 3e-3
MULTI_TOL = 5e-3
GREEDY_MARGIN = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def ref():
    jcfg = jget(ARCH).smoke()
    jp = mp.ref_params(jcfg, 0)
    batch = mp.batch_np(jcfg, B, S, seed=1)
    weighted = dict(batch, loss_weight=LOSS_WEIGHT)
    logits = jax.jit(lambda p, b: japi.forward(p, b, jcfg))(jp, mp.to_jax(batch))
    loss, paths, grads = mp.reference_grads(jp, weighted, jcfg)
    ids, steps = mp.reference_greedy(jp, mp.prefix(batch, PROMPT), jcfg, PROMPT + GEN, GEN)
    return types.SimpleNamespace(jcfg=jcfg, cfg=get_config(ARCH).smoke(), jp=jp, batch=batch,
                                 weighted=weighted, logits=np.asarray(logits), loss=loss,
                                 paths=paths, grads=grads, ids=ids, steps=steps)


# -- the block's pieces -------------------------------------------------------

def test_segsum_matches_reference_and_its_mask_passes_no_nan():
    a = -np.abs(_rng(0).standard_normal((2, 3, 7))).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    got = ssm._segsum(_t(a))
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got.numpy()), finite)
    assert np.all(got.numpy()[~finite] == -np.inf)
    np.testing.assert_allclose(got.numpy()[finite], want[finite], rtol=1e-6, atol=1e-6)
    # the gradient through exp(segsum) is 0 above the diagonal, not NaN
    w = _rng(1).standard_normal((2, 3, 7, 7)).astype(np.float32)
    jg = np.asarray(jax.grad(lambda x: jnp.sum(jnp.exp(jssm._segsum(x)) * w))(jnp.asarray(a)))
    x = _t(a).requires_grad_(True)
    (g,) = torch.autograd.grad((torch.exp(ssm._segsum(x)) * _t(w)).sum(), x)
    assert torch.isfinite(g).all()
    assert mp.rel_err(g, jg) <= mp.TOL


def test_causal_conv_matches_reference():
    rng = _rng(2)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert mp.rel_err(ssm._causal_conv(_t(x), _t(w), _t(b)), want) <= mp.TOL


def test_gated_norm_matches_reference():
    rng = _rng(3)
    y, z = (rng.standard_normal((2, 5, 32)).astype(np.float32) for _ in range(2))
    scale = rng.standard_normal(32).astype(np.float32)
    want = jssm._gated_norm(jnp.asarray(y), jnp.asarray(z), jnp.asarray(scale))
    assert mp.rel_err(ssm._gated_norm(_t(y), _t(z), _t(scale)), want) <= mp.TOL


def _ssd_inputs(s, seed, nh=8, hp=16, g=1, n=16, dtype=np.float32):
    rng = _rng(seed)
    xh = rng.standard_normal((2, s, nh, hp)).astype(dtype)
    da = -np.abs(rng.standard_normal((2, s, nh))).astype(np.float32) * 0.5
    bm, cm = (rng.standard_normal((2, s, g, n)).astype(dtype) for _ in range(2))
    state0 = rng.standard_normal((2, nh, hp, n)).astype(np.float32)
    return xh, da, bm, cm, state0


@pytest.mark.parametrize("s,chunk,with_state", [(15, 8, False), (15, 8, True), (32, 16, True),
                                                (7, 16, False)],
                         ids=["ragged", "ragged-state0", "two-chunks-state0", "one-chunk"])
def test_mamba_chunked_matches_reference(s, chunk, with_state):
    """At 15 tokens and chunk 8 the chunk is 5 (three chunks), as in the
    reference's own prefill of 15 tokens."""
    cfg = get_config(ARCH).smoke(ssm_chunk=chunk)
    xh, da, bm, cm, state0 = _ssd_inputs(s, seed=s + chunk)
    st = state0 if with_state else None
    want_y, want_f = jssm.mamba_chunked(*map(jnp.asarray, (xh, da, bm, cm)), cfg,
                                        None if st is None else jnp.asarray(st))
    y, final = ssm.mamba_chunked(*map(_t, (xh, da, bm, cm)), cfg, None if st is None else _t(st))
    assert final.dtype == torch.float32
    assert mp.rel_err(y, want_y) <= mp.TOL
    assert mp.rel_err(final, want_f) <= mp.TOL


def test_mamba_chunked_gradients_match_reference():
    """Gradients through the masked exp, the chunk loop and the starting
    state are finite and the reference's."""
    cfg = get_config(ARCH).smoke(ssm_chunk=8)
    inputs = _ssd_inputs(15, seed=9)
    wy = _rng(10).standard_normal((2, 15, 8, 16)).astype(np.float32)
    wf = _rng(11).standard_normal((2, 8, 16, 16)).astype(np.float32)

    def jloss(xh, da, bm, cm, s0):
        y, f = jssm.mamba_chunked(xh, da, bm, cm, cfg, s0)
        return jnp.sum(y * wy) + jnp.sum(f * wf)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, inputs))
    args = [_t(a).requires_grad_(True) for a in inputs]
    y, f = ssm.mamba_chunked(*args[:4], cfg, args[4])
    got = torch.autograd.grad((y * _t(wy)).sum() + (f * _t(wf)).sum(), args)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert mp.rel_err(g, w) <= mp.GRAD_TOL


def _layer_params(jcfg, seed):
    return jssm.init_mamba_block(jax.random.key(seed), jcfg)


def test_mamba_step_matches_reference():
    jcfg = jget(ARCH).smoke()
    cfg = get_config(ARCH).smoke()
    jp = _layer_params(jcfg, 4)
    rng = _rng(5)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    state = {k: rng.standard_normal(v.shape[1:]).astype(np.float32)
             for k, v in jssm.init_ssm_state(jcfg, 2, 1).items()}
    want_y, want_st = jax.jit(lambda p, x, st: jssm.mamba_step(p, x, jcfg, st))(
        jp, jnp.asarray(x), mp.to_jax(state))
    before = {k: _t(v).clone() for k, v in state.items()}
    given = {k: _t(v) for k, v in state.items()}
    y, st = ssm.mamba_step(mp.to_port(jp), _t(x), cfg, given)
    assert mp.rel_err(y, want_y) <= mp.TOL
    mp.assert_tree_close(st, want_st)
    assert all(torch.equal(before[k], given[k]) for k in state)


# -- the LM ---------------------------------------------------------------------

def test_forward_matches_reference(ref):
    logits = api.forward(mp.to_port(ref.jp), mp.to_port(ref.batch), ref.cfg)
    assert logits.dtype == torch.float32 and logits.shape == (B, S, ref.cfg.vocab)
    assert mp.rel_err(logits, ref.logits) <= mp.TOL


def test_loss_and_gradients_match_reference(ref):
    loss, grads = mp.loss_and_grads(mp.to_port(ref.jp), mp.to_port(ref.weighted), ref.cfg)
    assert abs(float(loss) - ref.loss) <= mp.TOL * abs(ref.loss)
    mp.assert_grads_match(grads, ref.grads, ref.paths)


def test_ssm_loss_fn_matches_reference(ref):
    """``ssm.loss_fn``: mean NLL plus the 1e-4 z-loss, unweighted."""
    want = float(jax.jit(lambda p, b: jssm.loss_fn(p, b, ref.jcfg))(ref.jp,
                                                                     mp.to_jax(ref.batch)))
    got = float(ssm.loss_fn(mp.to_port(ref.jp), mp.to_port(ref.batch), ref.cfg))
    assert abs(got - want) <= mp.TOL * abs(want)


@pytest.mark.parametrize("s", [1, 2, 3, 15])
def test_prefill_caches_match_reference(ref, s):
    """Prompts of 1 and 2 tokens, shorter than the conv window of 3 inputs,
    leave the reference's shorter conv tails (its slice from s - 3 keeps the
    last 1 token of either); 3 and 15 a whole window."""
    pre = mp.prefix(ref.batch, s)
    want_l, want_c = jax.jit(lambda p, b: japi.prefill(p, b, ref.jcfg))(ref.jp, mp.to_jax(pre))
    with torch.no_grad():
        lp, cache = api.prefill(mp.to_port(ref.jp), mp.to_port(pre), ref.cfg)
    assert mp.rel_err(lp, want_l) <= mp.TOL
    mp.assert_tree_close(cache, want_c)
    assert cache["len"].device.type == "cpu" and cache["len"].dtype == torch.int32
    assert cache["state"]["conv_x"].shape[2] == len(range(s)[s - (ref.cfg.ssm_conv - 1):])


def test_decode_step_matches_reference_and_writes_no_cache(ref):
    pre = mp.prefix(ref.batch, S - 1)
    tok = ref.batch["tokens"][:, S - 1:]
    _, jc = jax.jit(lambda p, b: japi.prefill(p, b, ref.jcfg))(ref.jp, mp.to_jax(pre))
    want_l, want_c = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, ref.jcfg))(
        ref.jp, jc, jnp.asarray(tok))
    params = mp.to_port(ref.jp)
    with torch.no_grad():
        _, cache = api.prefill(params, mp.to_port(pre), ref.cfg)
        before = [t.clone() for t in leaves(cache)]
        ld, cache2 = api.decode_step(params, cache, _t(tok), ref.cfg)
    assert mp.rel_err(ld, want_l) <= mp.TOL
    mp.assert_tree_close(cache2, want_c)
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(cache)))


def test_greedy_ids_over_eight_steps_match_reference(ref):
    from repro_torch.launch.serve import generate

    for logits in ref.steps:
        top = np.sort(logits, axis=-1)
        assert (top[:, -1] - top[:, -2]).min() >= GREEDY_MARGIN * np.abs(logits).max()
    run = generate(mp.to_port(ref.jp), mp.to_port(mp.prefix(ref.batch, PROMPT)), ref.cfg, GEN,
                   s_max=PROMPT + GEN)
    np.testing.assert_array_equal(run.ids.numpy(), ref.ids)


def test_prefill_from_the_conv_width_then_decode_matches_forward(ref):
    """A prompt of ssm_conv - 1 = 3 tokens fills the conv window: decoding
    on from it follows the forward pass."""
    params = mp.to_port(ref.jp)
    toks = _t(ref.batch["tokens"][:, :12])
    with torch.no_grad():
        full = api.forward(params, {"tokens": toks}, ref.cfg)
        lp, cache = api.prefill(params, {"tokens": toks[:, :3]}, ref.cfg)
        np.testing.assert_allclose(lp.numpy(), full[:, 2].numpy(), rtol=SERVE_TOL,
                                   atol=SERVE_TOL)
        for t in range(3, 12):
            ld, cache = api.decode_step(params, cache, toks[:, t:t + 1], ref.cfg)
            np.testing.assert_allclose(ld.numpy(), full[:, t].numpy(), rtol=MULTI_TOL,
                                       atol=MULTI_TOL)


# -- the reference's own Mamba2 tests on the port -------------------------------

def test_mamba2_state_equivalence():
    """Chunked SSD (training) must equal the sequential decode recurrence
    (tests/test_models_smoke.py)."""
    cfg = dataclasses.replace(get_config(ARCH).smoke(n_layers=2), ssm_chunk=8)
    gen = torch.Generator().manual_seed(0)
    params = api.init(gen, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen, dtype=torch.int32)
    with torch.no_grad():
        full = api.forward(params, {"tokens": toks}, cfg)
        _, cache = api.prefill(params, {"tokens": toks[:, :15]}, cfg)
        ld, _ = api.decode_step(params, cache, toks[:, 15:16], cfg)
    np.testing.assert_allclose(ld.numpy(), full[:, -1].numpy(), rtol=STATE_TOL, atol=STATE_TOL)


# -- bf16: the reference's casts one for one ------------------------------------

def _bf16(a):
    return a.astype(ml_dtypes.bfloat16)


def test_bf16_mamba_chunked_matches_reference():
    cfg = get_config(ARCH).smoke(dtype="bfloat16", ssm_chunk=8)
    xh, da, bm, cm, state0 = _ssd_inputs(15, seed=12)
    xh, bm, cm = _bf16(xh), _bf16(bm), _bf16(cm)
    want_y, want_f = jssm.mamba_chunked(*map(jnp.asarray, (xh, da, bm, cm)), cfg,
                                        jnp.asarray(state0))
    port = mp.to_port({"xh": xh, "da": da, "bm": bm, "cm": cm, "s0": state0})
    y, final = ssm.mamba_chunked(port["xh"], port["da"], port["bm"], port["cm"], cfg, port["s0"])
    assert y.dtype == torch.bfloat16 and final.dtype == torch.float32
    assert str(want_y.dtype) == "bfloat16"
    assert mp.rel_err(y, want_y) <= BF16_TOL
    assert mp.rel_err(final, want_f) <= BF16_TOL


def test_bf16_mamba_step_and_layer_match_reference():
    jcfg = jget(ARCH).smoke(dtype="bfloat16")
    cfg = get_config(ARCH).smoke(dtype="bfloat16")
    jp = _layer_params(jcfg, 6)
    rng = _rng(7)
    x = _bf16(rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32))
    want_y, (want_st, want_tail) = jax.jit(lambda p, x: jssm.mamba_block(p, x, jcfg))(
        jp, jnp.asarray(x))
    p = mp.to_port(jp)
    xt = mp.to_port({"x": x})["x"]
    y, (st, tail) = ssm.mamba_block(p, xt, cfg)
    assert y.dtype == torch.bfloat16 and str(want_y.dtype) == "bfloat16"
    assert mp.rel_err(y, want_y) <= BF16_TOL
    assert mp.rel_err(st, want_st) <= BF16_TOL
    state = {"ssm": np.asarray(want_st), "conv_x": np.asarray(want_tail[0]),
             "conv_bc": np.asarray(want_tail[1])}
    x1 = x[:, :1]
    want_y1, want_st1 = jax.jit(lambda p, x, st: jssm.mamba_step(p, x, jcfg, st))(
        jp, jnp.asarray(x1), mp.to_jax(state))
    y1, st1 = ssm.mamba_step(p, xt[:, :1], cfg, mp.to_port(state))
    assert y1.dtype == torch.bfloat16
    assert mp.rel_err(y1, want_y1) <= BF16_TOL
    assert mp.rel_err(st1["ssm"], want_st1["ssm"]) <= BF16_TOL
    assert torch.equal(st1["conv_x"], mp.to_port({"c": want_st1["conv_x"]})["c"])


# -- remat, specs, round trip ---------------------------------------------------

def test_remat_changes_no_bit(ref):
    outs = []
    for remat in (False, True):
        cfg = get_config(ARCH).smoke(remat=remat)
        params, batch = mp.to_port(ref.jp), mp.to_port(ref.weighted)
        outs.append((api.forward(params, batch, cfg).detach(),
                     *mp.loss_and_grads(params, batch, cfg)))
    (l0, loss0, g0), (l1, loss1, g1) = outs
    assert torch.equal(l0, l1) and torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _specs(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)


@pytest.mark.parametrize("size", ["smoke", "published"])
def test_param_specs_match_reference(size):
    jcfg = jget(ARCH) if size == "published" else jget(ARCH).smoke()
    cfg = get_config(ARCH) if size == "published" else get_config(ARCH).smoke()
    specs = api.param_specs(cfg)
    assert all(t.device.type == "meta" for t in leaves(specs))
    assert _specs(specs) == _specs(japi.param_specs(jcfg))
    assert _specs(api.decode_cache_specs(cfg, 2, 40)) == _specs(
        japi.decode_cache_specs(jcfg, 2, 40))


def test_bf16_params_round_trip():
    jp = mp.ref_params(jget(ARCH).smoke(dtype="bfloat16"), 0)
    port = mp.to_port(jp)
    assert port["layers"]["block"]["w_x"].dtype == torch.bfloat16
    assert port["layers"]["block"]["A_log"].dtype == torch.float32
    back = params_to_reference(port)
    want = mp.to_numpy(jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
