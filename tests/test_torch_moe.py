"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's on the CPU, at the ``smoke()`` sizes of qwen2-moe-a2.7b (60 → 4
routed experts top-4 → top-2, one shared expert) and mixtral-8x22b (8 → 4
experts, top-2).

Checked: routing ids (exactly) and weights; the dispatch slots against a
plain loop; the capacity dispatch at ``capacity_factor=1.0``, where
assignments are dropped; the whole layer with its shared expert; the decode
paths (``_moe_gather``, ``moe_decode_groups``) and ``moe_scan_experts``,
each against the reference and against the port's einsum dispatch;
gradients into every weight, the router included.  The reference's outputs
are computed once per module.  Routing is exact by construction: each
token's k-th and (k+1)-th probabilities are at least ``MARGIN`` apart, far
above the CPU products' rounding, so no id can flip between the two sides.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

import model_parity as mp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim._tree import leaves  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x22b"]
B, S, DECODE_B = 2, 32, 4
MARGIN = 1e-5
# routing weights: f32 softmax of the same logits on both sides
WEIGHT_TOL = 1e-6


def _cfgs(arch, **kw):
    return jget(arch).smoke(capacity_factor=1.0, **kw), get_config(arch).smoke(
        capacity_factor=1.0, **kw)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    jcfg, cfg = _cfgs(arch)
    jp = jmoe.init_moe(jax.random.key(0), jcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    xd = rng.standard_normal((DECODE_B, 1, cfg.d_model)).astype(np.float32)
    jgroups, _ = _cfgs(arch, moe_decode_groups=2)
    jscan, _ = _cfgs(arch, moe_scan_experts=True)
    probe = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def probed(p, x):
        return jnp.sum(jmoe.moe(p, x, jcfg) * probe)

    run = jax.jit(lambda p, x, xd: dict(
        route=jmoe._route(p, x, jcfg),
        probs=jax.nn.softmax(x @ p["router"], axis=-1),
        dispatch=jmoe._moe_dispatch(p, x, jcfg),
        layer=jmoe.moe(p, x, jcfg),
        shared=jmoe._shared(p, x, jcfg),
        gather=jmoe._moe_gather(p, xd, jcfg),
        decode=jmoe.moe(p, xd, jcfg),
        grouped=jmoe.moe(p, xd, jgroups),
        scanned=jmoe.moe(p, x, jscan),
        grads=jax.grad(probed)(p, x),
    ))
    out = mp.to_numpy(run(jp, jnp.asarray(x), jnp.asarray(xd)))
    return types.SimpleNamespace(arch=arch, cfg=cfg, p=mp.to_port(jp), x=torch.from_numpy(x),
                                 xd=torch.from_numpy(xd), probe=torch.from_numpy(probe), **out)


def test_routing_has_no_near_ties(case):
    top = np.sort(case.probs, axis=-1)[..., ::-1]
    k = case.cfg.top_k
    assert (top[..., k - 1] - top[..., k]).min() >= MARGIN


def test_route_matches_reference(case):
    w, ids = moe._route(case.p, case.x, case.cfg)
    want_w, want_ids = case.route
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    assert mp.rel_err(w, want_w) <= WEIGHT_TOL


def test_top_k_breaks_ties_toward_the_lower_index():
    cfg = get_config("mixtral-8x22b").smoke()
    p = {"router": torch.zeros(4, cfg.n_experts)}
    w, ids = moe._route(p, torch.ones(1, 3, 4), cfg)
    assert ids.tolist() == [[[0, 1]] * 3]
    assert torch.equal(w, torch.full((1, 3, 2), 0.5))
    assert jmoe._route({"router": jnp.zeros((4, cfg.n_experts))},
                       jnp.ones((1, 3, 4)), cfg)[1].tolist() == ids.tolist()


def _slots_by_loop(ids, e, c):
    """Each sequence's assignments in token order, numbered per expert;
    past ``c`` they go to the sentinel e·c."""
    b = ids.shape[0]
    flat = ids.reshape(b, -1)
    out = np.empty_like(flat)
    for i in range(b):
        seen = [0] * e
        for a, ex in enumerate(flat[i]):
            out[i, a] = ex * c + seen[ex] if seen[ex] < c else e * c
            seen[ex] += 1
    return out


def test_dispatch_slots_drop_past_capacity(case):
    cfg = case.cfg
    c = moe.capacity(cfg, S)
    assert c == jmoe.capacity(cfg, S)
    ids = torch.from_numpy(np.array(case.route[1])).long()
    slots = moe._dispatch_slots(ids, cfg.n_experts, c)
    np.testing.assert_array_equal(slots.numpy(), _slots_by_loop(ids.numpy(), cfg.n_experts, c))
    assert (slots == cfg.n_experts * c).any(), "capacity_factor=1.0 dropped nothing"
    for row in slots:                       # kept slots are distinct in each sequence
        kept = row[row < cfg.n_experts * c]
        assert kept.numel() == kept.unique().numel()


@pytest.mark.parametrize("s", [1, 7, 32, 512, 4096])
def test_capacity_matches_reference(case, s):
    for cf in (1.0, 1.25, 4.0):
        cfg = get_config(case.arch).smoke(capacity_factor=cf)
        assert moe.capacity(cfg, s) == jmoe.capacity(cfg, s)


def test_dispatch_with_drops_matches_reference(case):
    assert mp.rel_err(moe._moe_dispatch(case.p, case.x, case.cfg), case.dispatch) <= mp.TOL


def test_layer_matches_reference(case):
    assert mp.rel_err(moe.moe(case.p, case.x, case.cfg), case.layer) <= mp.TOL


def test_shared_expert_matches_reference(case):
    got = moe._shared(case.p, case.x, case.cfg)
    if case.cfg.n_shared_experts:
        assert mp.rel_err(got, case.shared) <= mp.TOL
    else:
        assert got == 0.0 and float(case.shared) == 0.0


def test_decode_gather_matches_reference_and_the_einsum_path(case):
    cfg = case.cfg
    got = moe._moe_gather(case.p, case.xd, cfg)
    assert mp.rel_err(got, case.gather) <= mp.TOL
    assert mp.rel_err(moe.moe(case.p, case.xd, cfg), case.decode) <= mp.TOL
    # the decode tokens as one sequence through the capacity dispatch, with
    # room for every assignment: the same expert sums
    roomy = get_config(case.arch).smoke()
    assert moe.capacity(roomy, DECODE_B) >= DECODE_B * cfg.top_k
    einsum = moe._moe_dispatch(case.p, case.xd.reshape(1, DECODE_B, -1), roomy)
    assert mp.rel_err(got, einsum.reshape(DECODE_B, 1, -1).numpy()) <= mp.TOL


def test_decode_groups_match_reference_and_the_gather_path(case):
    cfg = get_config(case.arch).smoke(capacity_factor=1.0, moe_decode_groups=2)
    got = moe.moe(case.p, case.xd, cfg)
    assert mp.rel_err(got, case.grouped) <= mp.TOL
    assert mp.rel_err(got, moe.moe(case.p, case.xd, case.cfg).numpy()) <= mp.TOL


def test_scan_experts_matches_reference_and_the_einsum_path(case):
    cfg = get_config(case.arch).smoke(capacity_factor=1.0, moe_scan_experts=True)
    got = moe.moe(case.p, case.x, cfg)
    assert mp.rel_err(got, case.scanned) <= mp.TOL
    assert mp.rel_err(got, moe.moe(case.p, case.x, case.cfg).numpy()) <= mp.TOL


def test_gradients_reach_every_weight(case):
    """∂Σ(moe(x)·probe)/∂p against the reference's, the router's through the
    renormalized top-k weights."""
    flat = leaves(case.p)
    for t in flat:
        t.requires_grad_(True)
    loss = (moe.moe(case.p, case.x, case.cfg) * case.probe).sum()
    grads = torch.autograd.grad(loss, flat)
    want = jax.tree.leaves(case.grads)
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        assert np.abs(w).max() > 0
        assert mp.rel_err(got, w) <= mp.GRAD_TOL


def test_rerun_is_bit_for_bit(case):
    a = moe.moe(case.p, case.x, case.cfg)
    b = moe.moe(case.p, case.x, case.cfg)
    assert torch.equal(a, b)
