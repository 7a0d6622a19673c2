"""The port's Zamba2 hybrid (``repro_torch.models.hybrid``) against the JAX
package's on the CPU, at ``smoke()`` sizes, without a tail (2 layers at
``attn_every`` 2: one unit) and with one (5 layers: two units and a tail
layer, the shape of the published 81 = 13 × 6 + 3).

The reference's parameters are carried across with ``params_from_reference``
(its None tail included) and the same numpy batch goes through both sides.
Checked, within ``model_parity.TOL`` (gradients ``GRAD_TOL``): forward;
``loss_fn`` with a blanking ``loss_weight`` and its gradients leaf for leaf,
the shared block's (the sum over its applications) among them; the prefill
caches (Mamba states, one KV cache per application of the shared block) and
``decode_step``; greedy ids over 8 steps; remat bit for bit;
``param_specs`` and the decode cache's specs on the meta device; the bf16
parameter round trip and the ``LM`` module with a None tail.  The
reference's outputs are computed once per shape.
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
from repro.models import hybrid as jhybrid  # noqa: E402

import model_parity as mp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import api, hybrid, params_to_reference  # noqa: E402
from repro_torch.optim._tree import leaves  # noqa: E402

ARCH = "zamba2-7b"
B, S = 2, 24
LOSS_WEIGHT = np.array([1.0, 0.0], np.float32)
GEN, PROMPT = 8, 12
S_MAX = S + 4
GREEDY_MARGIN = 1e-4
SHAPES = {"no-tail": 2, "tail": 5}


@pytest.fixture(scope="module", params=list(SHAPES), ids=list(SHAPES))
def case(request):
    n_layers = SHAPES[request.param]
    jcfg = jget(ARCH).smoke(n_layers=n_layers)
    jp = mp.ref_params(jcfg, 3)
    batch = mp.batch_np(jcfg, B, S, seed=4)
    weighted = dict(batch, loss_weight=LOSS_WEIGHT)
    logits = jax.jit(lambda p, b: japi.forward(p, b, jcfg))(jp, mp.to_jax(batch))
    loss, paths, grads = mp.reference_grads(jp, weighted, jcfg)
    prefill = jax.jit(lambda p, b: japi.prefill(p, b, jcfg, s_max=S_MAX))
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jcfg))
    lp, cache = prefill(jp, mp.to_jax(mp.prefix(batch, S - 1)))
    ld, cache2 = decode(jp, cache, jnp.asarray(batch["tokens"][:, S - 1:]))
    ids, steps = mp.reference_greedy(jp, mp.prefix(batch, PROMPT), jcfg, PROMPT + GEN, GEN)
    return types.SimpleNamespace(
        n_layers=n_layers, jcfg=jcfg, cfg=get_config(ARCH).smoke(n_layers=n_layers), jp=jp,
        batch=batch, weighted=weighted, logits=np.asarray(logits), loss=loss, paths=paths,
        grads=grads, lp=np.asarray(lp), cache=mp.to_numpy(cache), ld=np.asarray(ld),
        cache2=mp.to_numpy(cache2), ids=ids, steps=steps)


def test_shapes_with_and_without_a_tail(case):
    params = mp.to_port(case.jp)
    n_units, n_tail = hybrid._unit_counts(case.cfg)
    assert (n_units, n_tail) == {2: (1, 0), 5: (2, 1)}[case.n_layers]
    assert (params["tail"] is None) == (n_tail == 0) == (case.jp["tail"] is None)
    assert params["units"]["block"]["w_x"].shape[:2] == (n_units, case.cfg.attn_every)
    assert params["shared"]["attn"]["wq"].dim() == 2          # one copy


def test_forward_matches_reference(case):
    logits = api.forward(mp.to_port(case.jp), mp.to_port(case.batch), case.cfg)
    assert logits.dtype == torch.float32 and logits.shape == (B, S, case.cfg.vocab)
    assert mp.rel_err(logits, case.logits) <= mp.TOL


def test_loss_and_gradients_match_reference(case):
    """The shared block's gradient is the sum over its applications, which
    autograd forms and the reference's ``jax.grad`` forms."""
    loss, grads = mp.loss_and_grads(mp.to_port(case.jp), mp.to_port(case.weighted), case.cfg)
    assert abs(float(loss) - case.loss) <= mp.TOL * abs(case.loss)
    assert sum(p.startswith("['shared']") for p in case.paths) == 9
    mp.assert_grads_match(grads, case.grads, case.paths)


def test_hybrid_loss_fn_matches_reference(case):
    want = float(jax.jit(lambda p, b: jhybrid.loss_fn(p, b, case.jcfg))(
        case.jp, mp.to_jax(case.batch)))
    got = float(hybrid.loss_fn(mp.to_port(case.jp), mp.to_port(case.batch), case.cfg))
    assert abs(got - want) <= mp.TOL * abs(want)


def test_prefill_and_decode_match_reference(case):
    params = mp.to_port(case.jp)
    with torch.no_grad():
        lp, cache = api.prefill(params, mp.to_port(mp.prefix(case.batch, S - 1)), case.cfg,
                                s_max=S_MAX)
        before = [t.clone() for t in leaves(cache)]
        ld, cache2 = api.decode_step(params, cache, torch.from_numpy(
            case.batch["tokens"][:, S - 1:]), case.cfg)
    assert mp.rel_err(lp, case.lp) <= mp.TOL
    mp.assert_tree_close(cache, case.cache)
    assert mp.rel_err(ld, case.ld) <= mp.TOL
    mp.assert_tree_close(cache2, case.cache2)
    n_units, _ = hybrid._unit_counts(case.cfg)
    assert cache2["kv"]["k"].shape == (n_units, B, case.cfg.n_kv_heads, S_MAX, case.cfg.d_head)
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(cache)))


def test_greedy_ids_over_eight_steps_match_reference(case):
    for logits in case.steps:
        top = np.sort(logits, axis=-1)
        assert (top[:, -1] - top[:, -2]).min() >= GREEDY_MARGIN * np.abs(logits).max()
    run = generate(mp.to_port(case.jp), mp.to_port(mp.prefix(case.batch, PROMPT)), case.cfg,
                   GEN, s_max=PROMPT + GEN)
    np.testing.assert_array_equal(run.ids.numpy(), case.ids)


def test_remat_changes_no_bit(case):
    outs = []
    for remat in (False, True):
        cfg = get_config(ARCH).smoke(n_layers=case.n_layers, remat=remat)
        params, batch = mp.to_port(case.jp), mp.to_port(case.weighted)
        with torch.no_grad():
            pre = api.prefill(params, mp.to_port(mp.prefix(case.batch, S - 1)), cfg,
                              s_max=S_MAX)
        outs.append((api.forward(params, batch, cfg).detach(),
                     *mp.loss_and_grads(params, batch, cfg), pre))
    (l0, loss0, g0, p0), (l1, loss1, g1, p1) = outs
    assert torch.equal(l0, l1) and torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert torch.equal(p0[0], p1[0])
    assert all(torch.equal(a, b) for a, b in zip(leaves(p0[1]), leaves(p1[1])))


def _specs(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)


@pytest.mark.parametrize("size", ["smoke", "smoke-tail", "published"])
def test_param_specs_match_reference(size):
    kw = {"smoke-tail": dict(n_layers=5), "smoke": {}}.get(size)
    jcfg = jget(ARCH) if kw is None else jget(ARCH).smoke(**kw)
    cfg = get_config(ARCH) if kw is None else get_config(ARCH).smoke(**kw)
    specs = api.param_specs(cfg)
    assert all(t.device.type == "meta" for t in leaves(specs))
    assert _specs(specs) == _specs(japi.param_specs(jcfg))
    assert _specs(api.decode_cache_specs(cfg, 2, 40)) == _specs(
        japi.decode_cache_specs(jcfg, 2, 40))
    if kw is not None:
        assert _specs(api.init(0, cfg, device="cpu")) == _specs(japi.param_specs(jcfg))


@pytest.mark.parametrize("n_layers", [2, 5])
def test_bf16_params_round_trip_and_lm_module(n_layers):
    jp = mp.ref_params(jget(ARCH).smoke(n_layers=n_layers, dtype="bfloat16"), 0)
    port = mp.to_port(jp)
    assert port["shared"]["attn"]["wq"].dtype == torch.bfloat16
    back = params_to_reference(port)
    want = mp.to_numpy(jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    cfg = get_config(ARCH).smoke(n_layers=n_layers)
    lm = api.LM(cfg, device="cpu")
    tree = lm.tree()
    assert (tree["tail"] is None) == (n_layers == 2)
    assert len(list(lm.parameters())) == len(leaves(tree)) == len(jax.tree.leaves(want))
