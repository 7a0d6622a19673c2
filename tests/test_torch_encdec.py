"""The port's Whisper enc-dec (``repro_torch.models.encdec``) against the JAX
package's on the CPU, at ``smoke()`` sizes (2 encoder and 2 decoder layers,
d_model 64, 16 frames, LayerNorm with biases, attention biases, tied
embeddings).

The reference's parameters are carried across with ``params_from_reference``
and the same numpy tokens and frames go through both sides.  Checked, within
``model_parity.TOL`` (gradients ``GRAD_TOL``): ``sinusoid`` (with an
offset), ``encode``, ``_cross_kv``; forward from ``frames`` and from
``enc_out``; ``loss_fn`` with a blanking ``loss_weight`` and its gradients
leaf for leaf (the key biases, whose exact gradient is 0, absolutely); the
prefill caches (self and cross K/V) and ``decode_step``; greedy ids over 8
steps; the reference's ``test_whisper_decode_uses_encoder``; remat bit for
bit; ``param_specs`` and the decode cache's specs on the meta device; the
bf16 parameter round trip.  The reference's outputs are computed once per
module.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402

import model_parity as mp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import api, encdec, params_to_reference  # noqa: E402
from repro_torch.optim._tree import leaves  # noqa: E402

ARCH = "whisper-medium"
B, S = 2, 24
LOSS_WEIGHT = np.array([1.0, 0.0], np.float32)
GEN, PROMPT = 8, 12
S_MAX = S + 4
GREEDY_MARGIN = 1e-4


@pytest.fixture(scope="module")
def ref():
    jcfg = jget(ARCH).smoke()
    jp = mp.ref_params(jcfg, 5)
    batch = mp.batch_np(jcfg, B, S, seed=6)
    weighted = dict(batch, loss_weight=LOSS_WEIGHT)
    logits = jax.jit(lambda p, b: japi.forward(p, b, jcfg))(jp, mp.to_jax(batch))
    enc = jax.jit(lambda p, f: jencdec.encode(p, f, jcfg))(jp, jnp.asarray(batch["frames"]))
    loss, paths, grads = mp.reference_grads(jp, weighted, jcfg)
    prefill = jax.jit(lambda p, b: japi.prefill(p, b, jcfg, s_max=S_MAX))
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jcfg))
    lp, cache = prefill(jp, mp.to_jax(mp.prefix(batch, S - 1)))
    ld, cache2 = decode(jp, cache, jnp.asarray(batch["tokens"][:, S - 1:]))
    ids, steps = mp.reference_greedy(jp, mp.prefix(batch, PROMPT), jcfg, PROMPT + GEN, GEN)
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=get_config(ARCH).smoke(), jp=jp, batch=batch, weighted=weighted,
        logits=np.asarray(logits), enc=np.array(enc), loss=loss, paths=paths, grads=grads,
        lp=np.asarray(lp), cache=mp.to_numpy(cache), ld=np.asarray(ld),
        cache2=mp.to_numpy(cache2), ids=ids, steps=steps)


@pytest.mark.parametrize("s,d,offset", [(16, 64, 0), (1, 64, 23), (5, 1024, 7), (3, 2, 0)])
def test_sinusoid_matches_reference(s, d, offset):
    want = np.asarray(jencdec.sinusoid(s, d, offset=jnp.asarray(offset, jnp.int32)))
    got = encdec.sinusoid(s, d, offset=offset)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_encode_matches_reference(ref):
    got = encdec.encode(mp.to_port(ref.jp), torch.from_numpy(ref.batch["frames"]), ref.cfg)
    assert got.shape == (B, ref.cfg.enc_frames, ref.cfg.d_model)
    assert mp.rel_err(got, ref.enc) <= mp.TOL


def test_cross_kv_matches_reference(ref):
    """One decoder layer's cross K/V, with the attention biases."""
    assert ref.cfg.attn_bias
    lp = jax.tree.map(lambda a: a[1], ref.jp["dec"])
    lp["cross"]["bk"] = jnp.full_like(lp["cross"]["bk"], 0.25)     # biases that show
    lp["cross"]["bv"] = jnp.full_like(lp["cross"]["bv"], -0.5)
    want_k, want_v = jencdec._cross_kv(lp, jnp.asarray(ref.enc), ref.jcfg)
    k, v = encdec._cross_kv(mp.to_port(lp), torch.from_numpy(ref.enc), ref.cfg)
    assert k.shape == (B, ref.cfg.enc_frames, ref.cfg.n_kv_heads, ref.cfg.d_head)
    assert mp.rel_err(k, want_k) <= mp.TOL and mp.rel_err(v, want_v) <= mp.TOL


def test_forward_matches_reference_from_frames_and_from_enc_out(ref):
    params = mp.to_port(ref.jp)
    logits = api.forward(params, mp.to_port(ref.batch), ref.cfg)
    assert logits.dtype == torch.float32 and logits.shape == (B, S, ref.cfg.vocab)
    assert mp.rel_err(logits, ref.logits) <= mp.TOL
    tokens = torch.from_numpy(ref.batch["tokens"])
    again = encdec.forward(params, tokens, ref.cfg, enc_out=torch.from_numpy(ref.enc))
    assert mp.rel_err(again, ref.logits) <= mp.TOL
    with pytest.raises(ValueError, match="exactly one"):
        encdec.forward(params, tokens, ref.cfg)
    with pytest.raises(ValueError, match="exactly one"):
        encdec.forward(params, tokens, ref.cfg, frames=torch.from_numpy(ref.batch["frames"]),
                       enc_out=torch.from_numpy(ref.enc))


def test_loss_and_gradients_match_reference(ref):
    loss, grads = mp.loss_and_grads(mp.to_port(ref.jp), mp.to_port(ref.weighted), ref.cfg)
    assert abs(float(loss) - ref.loss) <= mp.TOL * abs(ref.loss)
    assert "['embed']['tok']" in ref.paths and "['embed']['out']" not in ref.paths  # tied
    mp.assert_grads_match(grads, ref.grads, ref.paths)


def test_encdec_loss_fn_matches_reference(ref):
    want = float(jax.jit(lambda p, b: jencdec.loss_fn(p, b, ref.jcfg))(ref.jp,
                                                                       mp.to_jax(ref.batch)))
    got = float(encdec.loss_fn(mp.to_port(ref.jp), mp.to_port(ref.batch), ref.cfg))
    assert abs(got - want) <= mp.TOL * abs(want)


def test_prefill_and_decode_match_reference(ref):
    params = mp.to_port(ref.jp)
    with torch.no_grad():
        lp, cache = api.prefill(params, mp.to_port(mp.prefix(ref.batch, S - 1)), ref.cfg,
                                s_max=S_MAX)
        before = [t.clone() for t in leaves(cache)]
        ld, cache2 = api.decode_step(params, cache, torch.from_numpy(
            ref.batch["tokens"][:, S - 1:]), ref.cfg)
    assert mp.rel_err(lp, ref.lp) <= mp.TOL
    mp.assert_tree_close(cache, ref.cache)
    assert mp.rel_err(ld, ref.ld) <= mp.TOL
    mp.assert_tree_close(cache2, ref.cache2)
    assert cache["cross_kv"]["k"].shape == (ref.cfg.n_layers, B, ref.cfg.enc_frames,
                                            ref.cfg.n_kv_heads, ref.cfg.d_head)
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(cache)))


def test_greedy_ids_over_eight_steps_match_reference(ref):
    for logits in ref.steps:
        top = np.sort(logits, axis=-1)
        assert (top[:, -1] - top[:, -2]).min() >= GREEDY_MARGIN * np.abs(logits).max()
    run = generate(mp.to_port(ref.jp), mp.to_port(mp.prefix(ref.batch, PROMPT)), ref.cfg, GEN,
                   s_max=PROMPT + GEN)
    np.testing.assert_array_equal(run.ids.numpy(), ref.ids)


def test_whisper_decode_uses_encoder():
    """Changing the audio frames must change decoder logits (cross-attn)
    (tests/test_serving.py).  The reference's change, frames + 1, shifts
    each frame by a constant that the encoder's first LayerNorm takes out,
    so it moves the logits by rounding only (3.6e-7 of max|logit| in the
    reference, which its ``np.allclose`` still tells apart); frames drawn
    anew move them by a large part of max|logit|."""
    cfg = get_config(ARCH).smoke()
    params = api.init(torch.Generator().manual_seed(7), cfg, device="cpu")
    b = api.synth_batch(torch.Generator().manual_seed(7), cfg, "prefill", 1, 8, device="cpu")
    other = api.synth_batch(torch.Generator().manual_seed(8), cfg, "prefill", 1, 8, device="cpu")
    assert b["frames"].shape == (1, cfg.enc_frames, cfg.d_model)
    with torch.no_grad():
        l1, _ = api.prefill(params, b, cfg)
        l2, _ = api.prefill(params, dict(b, frames=b["frames"] + 1.0), cfg)
        l3, _ = api.prefill(params, dict(b, frames=other["frames"]), cfg)
    assert not np.allclose(l1.numpy(), l2.numpy())
    assert mp.rel_err(l3, l1.numpy()) > 1e-2


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
    assert port["dec"]["cross"]["wk"].dtype == torch.bfloat16
    assert port["enc_norm"]["bias"].dtype == torch.float32
    back = params_to_reference(port)
    want = mp.to_numpy(jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
