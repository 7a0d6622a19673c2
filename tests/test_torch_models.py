"""The port's dense and VLM transformers (``repro_torch.models``) against the
JAX package's on the CPU, at ``smoke()`` sizes: olmo-1b, qwen3-0.6b,
minitron-4b, gemma2-9b and qwen2-vl-72b.

The reference's parameters are carried across with ``params_from_reference``
and the same numpy batch goes through both sides.  Checked: ``forward``;
``loss_fn`` with a ``loss_weight`` that blanks a row, and its gradients leaf
for leaf in ``jax.tree.leaves`` order; query-chunked attention and
``pad_heads_to``; ``remat`` on against off (bit for bit, within the port);
the parameter round trip through ``params_to_reference`` (bf16 included);
``init``'s tree, shapes and dtypes against the reference's ``param_specs``
(at the smoke and the published sizes); the ``LM`` module; the frontends.
Each architecture's reference outputs are computed once per module (one
jitted function each).  Tolerances: ``model_parity.TOL`` and ``GRAD_TOL``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax  # noqa: E402
import ml_dtypes  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.configs.base import list_archs as jlist_archs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import frontends as jfrontends  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402

import model_parity as mp  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import api, frontends, layers, params_to_reference  # noqa: E402
from repro_torch.models import encdec, hybrid, ssm, transformer  # noqa: E402
from repro_torch.optim._tree import leaves  # noqa: E402

ARCHS = ["olmo-1b", "qwen3-0.6b", "minitron-4b", "gemma2-9b", "qwen2-vl-72b"]
# the SSM, hybrid and enc-dec families (held to the reference in
# test_torch_ssm.py, test_torch_hybrid.py and test_torch_encdec.py), for the
# cases here that apply to every family
FAMILY_ARCHS = ["mamba2-2.7b", "zamba2-7b", "whisper-medium"]
B, S = 2, 32
LOSS_WEIGHT = np.array([1.0, 0.0], np.float32)     # the second row blanked
# bf16 forward against the reference's, relative to max|logit|: both round
# activations to bf16 at each op, in places that differ (XLA keeps f32 inside
# fused elementwise chains), which read 8.9e-3 (gemma2) and 1.29e-2 (qwen3)
# at these sizes.  The bound catches a wrong op or cast order that moves
# logits by whole bf16 steps, not a precision change: the f32 tests hold
# the arithmetic.
BF16_TOL = 3e-2


def _jforward(jcfg):
    return jax.jit(lambda p, b: japi.forward(p, b, jcfg))


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    jcfg = jget(arch).smoke()
    jp = mp.ref_params(jcfg, 0)
    batch = mp.batch_np(jcfg, B, S, seed=1)
    weighted = dict(batch, loss_weight=LOSS_WEIGHT)
    fn = jax.jit(lambda p, b: (japi.forward(p, b, jcfg),
                               jax.value_and_grad(japi.loss_fn)(p, b, jcfg),
                               jtransformer.loss_fn(p, b, jcfg)))
    logits, (loss, grads), ce = fn(jp, mp.to_jax(weighted))
    jchunk = jget(arch).smoke(q_chunk=8)
    jpad = jget(arch).smoke(pad_heads_to=8)
    jp_pad = mp.ref_params(jpad, 2)
    return types.SimpleNamespace(
        arch=arch, cfg=get_config(arch).smoke(), jp=jp, batch=batch, weighted=weighted,
        logits=np.asarray(logits), loss=float(loss), ce=float(ce),
        grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
        chunked=np.asarray(_jforward(jchunk)(jp, mp.to_jax(batch))),
        jp_pad=jp_pad, padded=np.asarray(_jforward(jpad)(jp_pad, mp.to_jax(batch))),
    )


def _port(case, **overrides):
    cfg = get_config(case.arch).smoke(**overrides)
    return cfg, mp.to_port(case.jp), mp.to_port(case.batch)


def _loss_and_grads(params, batch, cfg):
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss = api.loss_fn(params, batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, flat)


def test_forward_matches_reference(case):
    cfg, params, batch = _port(case)
    logits = api.forward(params, batch, cfg)
    assert logits.dtype == torch.float32 and logits.shape == (B, S, cfg.vocab)
    assert mp.rel_err(logits, case.logits) <= mp.TOL


def test_loss_and_gradients_match_reference(case):
    cfg, params, _ = _port(case)
    loss, grads = _loss_and_grads(params, mp.to_port(case.weighted), cfg)
    assert abs(float(loss) - case.loss) <= mp.TOL * abs(case.loss)
    assert [tuple(g.shape) for g in grads] == [g.shape for g in case.grads]
    for i, (got, want) in enumerate(zip(grads, case.grads)):
        assert mp.rel_err(got, want) <= mp.GRAD_TOL, (case.arch, i, want.shape)


def test_transformer_cross_entropy_matches_reference(case):
    """``transformer.loss_fn``: mean NLL plus the 1e-4 z-loss, unweighted."""
    cfg, params, batch = _port(case)
    ce = transformer.loss_fn(params, batch, cfg)
    assert abs(float(ce) - case.ce) <= mp.TOL * abs(case.ce)


def test_blanked_row_changes_no_gradient(case):
    """With ``loss_weight`` [1, 0] the second row's labels enter nowhere (its
    logits still enter the z-loss term): changing them moves no gradient,
    which the reference's BLANK semantics rely on."""
    cfg, params, batch = _port(case)
    other = dict(batch, tokens=batch["tokens"].clone(), labels=batch["labels"].clone())
    other["labels"][1] = (other["labels"][1] + 1) % cfg.vocab
    w = torch.from_numpy(LOSS_WEIGHT)
    _, g1 = _loss_and_grads(params, dict(batch, loss_weight=w), cfg)
    _, g2 = _loss_and_grads(params, dict(other, loss_weight=w), cfg)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_chunked_attention_matches_reference(case):
    cfg, params, batch = _port(case, q_chunk=8)
    chunked = api.forward(params, batch, cfg)
    assert mp.rel_err(chunked, case.chunked) <= mp.TOL
    assert mp.rel_err(chunked, case.logits) <= mp.TOL


def test_pad_heads_to_matches_reference(case):
    cfg = get_config(case.arch).smoke(pad_heads_to=8)
    params = mp.to_port(case.jp_pad)
    assert params["units"][0]["attn"]["wq"].shape[-1] == 8 * cfg.d_head
    logits = api.forward(params, mp.to_port(case.batch), cfg)
    assert mp.rel_err(logits, case.padded) <= mp.TOL


def test_remat_changes_no_bit(case):
    """``remat`` recomputes each unit in the backward pass; the forward
    values and the gradients stay the same bits."""
    outs = []
    for remat in (False, True):
        cfg, params, _ = _port(case, remat=remat)
        batch = mp.to_port(case.weighted)
        outs.append((api.forward(params, batch, cfg).detach(),
                     *_loss_and_grads(params, batch, cfg)))
    (l0, loss0, g0), (l1, loss1, g1) = outs
    assert torch.equal(l0, l1) and torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _assert_tree_bits(got, want):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(got_l, want_l):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(case, dtype):
    jcfg = jget(case.arch).smoke(dtype=dtype)
    jp = case.jp if dtype == "float32" else mp.ref_params(jcfg, 0)
    port = mp.to_port(jp)
    if dtype == "bfloat16":
        assert port["embed"]["tok"].dtype == torch.bfloat16
        assert params_to_reference(port)["embed"]["tok"].dtype == ml_dtypes.bfloat16
    _assert_tree_bits(params_to_reference(port), mp.to_numpy(jp))


def _specs(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)


@pytest.mark.parametrize("size", ["smoke", "published"])
def test_init_matches_reference_param_specs(case, size):
    jcfg = jget(case.arch) if size == "published" else jget(case.arch).smoke()
    cfg = get_config(case.arch) if size == "published" else case.cfg
    want = _specs(japi.param_specs(jcfg))
    assert _specs(api.param_specs(cfg)) == want
    if size == "smoke":
        assert _specs(api.init(0, cfg, device="cpu")) == want


def test_init_draws_the_reference_scales(case):
    """The port draws its own bits from the reference's distributions: norms
    and biases at their constants, N(0, scale²) weights."""
    cfg = case.cfg
    params = api.init(torch.Generator().manual_seed(5), cfg, device="cpu")
    tok = params["embed"]["tok"]
    assert abs(tok.std().item() - 0.02) < 0.002
    unit = params["units"][0]
    wq = unit["attn"]["wq"]
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    for norm in (unit["attn_norm"], params["final_norm"]):
        for k, v in norm.items():
            assert v.dtype == torch.float32
            assert torch.all(v == (0.0 if cfg.norm == "rmsnorm_offset" else 1.0))
    again = api.init(torch.Generator().manual_seed(5), cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(again)))


def test_lm_module_holds_the_tree(case):
    cfg, params, batch = _port(case)
    lm = api.LM(cfg, params)
    assert len(list(lm.parameters())) == len(leaves(params))
    tree = lm.tree()
    assert jax.tree.structure(_specs(tree)) == jax.tree.structure(_specs(params))
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(leaves(tree), leaves(params)))
    with torch.no_grad():
        assert torch.equal(lm(batch), api.forward(params, batch, cfg))
    fresh = api.LM(cfg, device="cpu")
    assert _specs(fresh.tree()) == _specs(params)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-9b"])
def test_bf16_forward_matches_reference(arch):
    """At ``dtype="bfloat16"`` (bf16 weights and activations, f32 scores,
    norms and logits, as in the reference) the logits are f32 and near the
    reference's, within the bf16 rounding that ``BF16_TOL`` allows."""
    jcfg = jget(arch).smoke(dtype="bfloat16")
    jp = mp.ref_params(jcfg, 0)
    batch = mp.batch_np(jcfg, B, S, seed=1)
    want = np.asarray(_jforward(jcfg)(jp, mp.to_jax(batch)))
    got = api.forward(mp.to_port(jp), mp.to_port(batch), get_config(arch).smoke(dtype="bfloat16"))
    assert got.dtype == torch.float32
    assert mp.rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("span", [None, (8, 24)])
def test_mrope_positions_match_reference(span):
    cfg = get_config("qwen2-vl-72b").smoke()
    got = frontends.mrope_positions(cfg, 2, 32, image_span=span, grid=(4, 4), device="cpu")
    want = np.asarray(jfrontends.mrope_positions(cfg, 2, 32, image_span=span, grid=(4, 4)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert frontends.mrope_positions_spec(cfg, 2, 32).shape == (3, 2, 32)


def test_frontend_and_batch_specs_match_reference():
    cfg = get_config("whisper-medium").smoke()
    jspec = jfrontends.audio_frames_spec(cfg, 3)
    spec = frontends.audio_frames_spec(cfg, 3)
    assert tuple(spec.shape) == jspec.shape and str(spec.dtype)[6:] == str(jspec.dtype)
    frames = frontends.audio_frames(torch.Generator().manual_seed(0), cfg, 3)
    assert frames.shape == jspec.shape and frames.dtype == torch.float32
    for arch in ("qwen2-vl-72b", "olmo-1b", "whisper-medium"):
        c = get_config(arch).smoke()
        for kind in ("train", "prefill", "decode"):
            got = {k: (tuple(v.shape), str(v.dtype)[6:])
                   for k, v in api.batch_specs(c, kind, 2, 16).items()}
            want = {k: (v.shape, str(v.dtype))
                    for k, v in japi.batch_specs(c, kind, 2, 16).items()}
            assert got == want, (arch, kind)


def test_synth_batch_has_the_reference_layout():
    for arch in ("qwen2-vl-72b", "qwen3-0.6b"):
        cfg = get_config(arch).smoke()
        got = api.synth_batch(0, cfg, "train", 2, 32, device="cpu")
        want = japi.synth_batch(jax.random.key(0), cfg, "train", 2, 32)
        assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
            k: (v.shape, torch.int32) for k, v in want.items()}
        assert torch.equal(got["labels"], torch.roll(got["tokens"], -1, dims=1))
        if "positions" in want:
            np.testing.assert_array_equal(got["positions"].numpy(),
                                          np.asarray(want["positions"]))
        assert int(got["tokens"].max()) < cfg.vocab


def test_waiting_families_name_their_roadmap_item():
    """No family waits any more: ``api.module_for`` routes every registered
    architecture to the module of the reference's family (the SSM, hybrid
    and enc-dec families included), and ``init`` draws each of them."""
    assert sorted(list_archs()) == sorted(jlist_archs()) and len(jlist_archs()) == 10
    for arch in jlist_archs():
        cfg = get_config(arch)
        mod = api.module_for(cfg)
        assert mod.__name__.rsplit(".", 1)[1] == japi.module_for(jget(arch)).__name__.rsplit(
            ".", 1)[1]
    for arch, mod in (("mamba2-2.7b", ssm), ("zamba2-7b", hybrid), ("whisper-medium", encdec)):
        cfg = get_config(arch).smoke()
        assert api.module_for(cfg) is mod
        params = api.init(0, cfg, device="cpu")
        assert _specs(params) == _specs(japi.param_specs(jget(arch).smoke()))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmo-1b"])
def test_cross_attention_matches_reference(arch):
    """``attention(..., kv=(k, v))``: queries over precomputed states, no
    mask, RoPE on the queries only (the enc-dec decoder's cross layer)."""
    jcfg = jget(arch).smoke()
    p = mp.to_numpy(jlayers.init_attention(jax.random.key(4), jcfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    kv = tuple(rng.standard_normal((2, 7, jcfg.n_kv_heads, jcfg.d_head)).astype(np.float32)
               for _ in range(2))
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    jcs = jlayers.rope_cos_sin(pos, jcfg.d_head, jcfg.rope_theta)
    want, aux = jlayers.attention(p, x, jcfg, cos_sin=jcs, kv=kv)
    cfg = get_config(arch).smoke()
    cs = layers.rope_cos_sin(torch.from_numpy(pos.copy()), cfg.d_head, cfg.rope_theta)
    assert mp.rel_err(cs[0], jcs[0]) <= mp.TOL and mp.rel_err(cs[1], jcs[1]) <= mp.TOL
    got, got_aux = layers.attention(mp.to_port(p), torch.from_numpy(x), cfg, cos_sin=cs,
                                    kv=tuple(torch.from_numpy(a) for a in kv))
    assert aux is None and got_aux is None
    assert mp.rel_err(got, want) <= mp.TOL


@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
def test_decode_cache_specs_match_reference(arch):
    cfg = get_config(arch).smoke()
    want = _specs(japi.decode_cache_specs(cfg, 2, 40))
    assert _specs(api.decode_cache_specs(cfg, 2, 40)) == want
    cache = api.init_decode_cache(cfg, 2, 40, device="cpu")
    assert _specs(cache) == want
    assert cache["len"].device.type == "cpu" and int(cache["len"]) == 0
    assert _specs(layers.init_cache(cfg, 2, 40, torch.bfloat16, device="cpu")) == _specs(
        jlayers.init_cache(cfg, 2, 40, jax.numpy.bfloat16))
