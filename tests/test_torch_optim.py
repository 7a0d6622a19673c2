"""The port's optimizers (``repro_torch.optim``) against the JAX package's on
the same numpy inputs, on the CPU.

Every case of the reference's ``tests/test_optim.py`` runs on both sides,
with the reference's own assertions applied to the port as well, except
``test_zero1_state_shardings_divisibility``: ``adamw.state_shardings``
returns ZeRO-1 ``PartitionSpec``s of a device mesh, which the
simulated-ranks backend has no counterpart for (ROADMAP A.3e).

Exact: plans, validity bits, NaN positions, PowerSGD's byte counts, the
errors raised.  Within a tolerance: numbers.  ``TOL`` is the reference's
own PowerSGD / CholeskyQR2 tolerance (``rtol=atol=2e-4``), applied to
max|port − reference| / max(1, max|reference|); the two sides run the same
float32 arithmetic in another summation order, so single steps agree to a
few ulps and multi-step runs to about 1e-5 (Adam's normalization and
CholeskyQR2 amplify the rounding).

The low-rank refresh draws a Gaussian sketch Ω, which the reference draws
from ``jax.random.key(0)``; the tests hand the port the reference's Ω
through ``lowrank.sketch`` (pytest's ``monkeypatch``, undone after each
test), and start PowerSGD on both sides from one numpy basis through
``state_from_reference``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import collective as jc  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import lowrank as jlowrank  # noqa: E402
from repro.optim import orthosgd as jortho  # noqa: E402
from repro.optim import powersgd as jpsgd  # noqa: E402
from repro.optim.ftqr import ft_cqr2_q as j_ft_cqr2_q  # noqa: E402

from repro_torch import collective as tc  # noqa: E402
from repro_torch.optim import adamw, lowrank, orthosgd, powersgd, state_from_reference  # noqa: E402
from repro_torch.optim._tree import leaves  # noqa: E402
from repro_torch.optim.ftqr import ft_cqr2_q  # noqa: E402

TOL = 2e-4


def _t(x):
    """numpy → CPU tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok]).max(initial=0.0)
    assert err <= tol * max(1.0, np.abs(want[ok]).max(initial=0.0)), err


def _trees_close(got, want, tol=TOL):
    got_l, want_l = leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        _close(g, w, tol)


@pytest.fixture
def ref_sketch(monkeypatch):
    """The port's basis refresh draws the reference's Ω."""
    def sketch(shape, device):
        omega = jax.random.normal(jax.random.key(0), shape, jnp.float32)
        return _t(omega).to(device)

    monkeypatch.setattr(lowrank, "sketch", sketch)


def _quad(rng, d=16):
    return rng.standard_normal((d, d)).astype(np.float32)


def _mse_grads(params, target):
    """Gradient of mean((w − target)²) on each side's own parameters."""
    return 2 * (params["w"] - target) / (target.shape[0] * target.shape[1])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    target = _quad(np.random.default_rng(0))
    cfg_kw = dict(lr=0.05, weight_decay=0.0, warmup=0, total_steps=200)
    jp, tp = {"w": jnp.zeros((16, 16))}, {"w": torch.zeros(16, 16)}
    js, ts = jadamw.init(jp), adamw.init(tp)
    jt, tt = jnp.asarray(target), _t(target)
    for _ in range(150):
        jp, js, _ = jadamw.update(jadamw.AdamWConfig(**cfg_kw), jp, {"w": _mse_grads(jp, jt)}, js)
        tp, ts, _ = adamw.update(adamw.AdamWConfig(**cfg_kw), tp, {"w": _mse_grads(tp, tt)}, ts)
    l0 = float(np.mean(target ** 2))
    assert float(torch.mean((tp["w"] - tt) ** 2)) < 0.02 * l0
    _trees_close(tp, jp)
    _trees_close({"m": ts["m"], "v": ts["v"]}, {"m": js["m"], "v": js["v"]})
    assert int(ts["step"]) == int(js["step"]) == 150


def test_adamw_grad_clip_and_schedule():
    cfg_kw = dict(lr=1.0, grad_clip=1e-3, warmup=10, total_steps=100, weight_decay=0.0)
    jp, tp = {"w": jnp.ones((4,))}, {"w": torch.ones(4)}
    jnew, _, jm = jadamw.update(jadamw.AdamWConfig(**cfg_kw), jp, {"w": jnp.full((4,), 100.0)},
                                jadamw.init(jp))
    tnew, _, tm = adamw.update(adamw.AdamWConfig(**cfg_kw), tp, {"w": torch.full((4,), 100.0)},
                               adamw.init(tp))
    assert float((tnew["w"] - tp["w"]).abs().max()) <= 0.1 + 1e-5
    assert float(tm["grad_norm"]) > 10
    assert float(tm["lr"]) == pytest.approx(0.1)
    _close(tnew["w"], jnew["w"])
    _close(tm["grad_norm"], jm["grad_norm"])
    _close(tm["lr"], jm["lr"])


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 250])
def test_adamw_schedule_matches_reference(step):
    cfg_kw = dict(lr=3e-3, warmup=10, total_steps=100, min_lr_ratio=0.1)
    want = jadamw.schedule(jadamw.AdamWConfig(**cfg_kw), jnp.asarray(step, jnp.int32))
    got = adamw.schedule(adamw.AdamWConfig(**cfg_kw), step)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert abs(float(got) - float(want)) <= 1e-6 * max(float(want), 1e-30)


def test_adamw_global_norm_over_a_tree():
    rng = np.random.default_rng(1)
    tree = {"b": rng.standard_normal(7).astype(np.float32),
            "a": [rng.standard_normal((3, 4)).astype(np.float32),
                  rng.standard_normal((2,)).astype(np.float32)]}
    want = jadamw.global_norm(jax.tree.map(jnp.asarray, tree))
    got = adamw.global_norm(jax.tree.map(_t, tree))
    _close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# PowerSGD with FT-TSQR orthogonalization (SimComm backend)
# ---------------------------------------------------------------------------

def _psum_id(x):
    return x


def _jpsum_model(x):
    return jnp.broadcast_to(x.sum(0, keepdims=True), x.shape)


def _tpsum_model(x):
    return x.sum(0, keepdim=True).expand(x.shape)


def _psgd_states(q0, p_ranks, m_loc, n, error_feedback):
    """The same start state on both sides: ``q0`` broadcast to every rank."""
    ref = {"q": np.broadcast_to(q0, (p_ranks,) + q0.shape).copy(),
           "e": np.zeros((p_ranks, m_loc, n), np.float32) if error_feedback else None}
    return jax.tree.map(jnp.asarray, ref), state_from_reference(ref, "cpu")


def _compress_both(g, states, p_ranks, cfg_kw, fault_spec=None):
    jcfg, tcfg = jpsgd.PowerSGDConfig(**cfg_kw), powersgd.PowerSGDConfig(**cfg_kw)
    jspec = tspec = None
    if fault_spec:
        jspec, tspec = jc.FaultSpec.of(fault_spec), tc.FaultSpec.of(fault_spec)
    want = jpsgd.compress_grad(jnp.asarray(g), states[0], jc.SimComm(p_ranks), cfg=jcfg,
                               psum_data=_psum_id, psum_model=_jpsum_model, n_data=1,
                               fault_spec=jspec)
    got = powersgd.compress_grad(_t(g), states[1], tc.SimComm(p_ranks, "cpu"), cfg=tcfg,
                                 psum_data=_psum_id, psum_model=_tpsum_model, n_data=1,
                                 fault_spec=tspec)
    return got, want


def _stats_equal(got, want):
    assert got["data_bytes_compressed"] == want["data_bytes_compressed"]
    assert got["data_bytes_dense"] == want["data_bytes_dense"]
    assert isinstance(got["data_bytes_compressed"], int)
    assert np.array_equal(_np(got["valid"]), np.asarray(want["valid"]))


def test_powersgd_exact_on_lowrank():
    """A rank-r gradient is reconstructed in one round, on both sides."""
    rng = np.random.default_rng(3)
    p_ranks, m_loc, n, r = 4, 32, 24, 4
    u = rng.standard_normal((p_ranks * m_loc, r)).astype(np.float32)
    v = rng.standard_normal((n, r)).astype(np.float32)
    g_full = (u @ v.T).reshape(p_ranks, m_loc, n)
    q0 = rng.standard_normal((n, r)).astype(np.float32)
    (g_hat, state, stats), (jg, jstate, jstats) = _compress_both(
        g_full, _psgd_states(q0, p_ranks, m_loc, n, False), p_ranks,
        dict(rank=r, error_feedback=False))
    np.testing.assert_allclose(_np(g_hat), g_full, rtol=1e-3, atol=1e-3)
    assert stats["data_bytes_compressed"] < stats["data_bytes_dense"]
    _stats_equal(stats, jstats)
    _close(g_hat, jg)
    _close(state["q"], jstate["q"])
    assert state["e"] is None and jstate["e"] is None


def test_powersgd_error_feedback_reduces_residual():
    rng = np.random.default_rng(4)
    p_ranks, m_loc, n, r = 4, 16, 16, 2
    g = rng.standard_normal((p_ranks, m_loc, n)).astype(np.float32)
    q0 = rng.standard_normal((n, r)).astype(np.float32)
    states = _psgd_states(q0, p_ranks, m_loc, n, True)
    acc_t, acc_j = torch.zeros(g.shape), jnp.zeros(g.shape)
    for _ in range(8):
        (g_hat, ts, stats), (jg, js, jstats) = _compress_both(
            g, states, p_ranks, dict(rank=r, error_feedback=True))
        states = (js, ts)
        acc_t, acc_j = acc_t + g_hat, acc_j + jg
        _stats_equal(stats, jstats)
    resid = float(torch.linalg.norm(_t(g) - acc_t / 8))
    assert resid < 0.9 * float(np.linalg.norm(g))
    _close(acc_t, acc_j)
    _close(ts["e"], js["e"])
    _close(ts["q"], js["q"])


@pytest.mark.parametrize("variant", ["redundant", "replace", "selfhealing"])
def test_powersgd_survives_rank_failure(variant):
    """A model-rank death at exchange 1 within the paper's bound: validity
    bits equal the reference's and the plan's on every variant; where the
    variant leaves a rank invalid its R is NaN, and form_q's Gram
    all-reduce spreads the NaN on both sides alike."""
    rng = np.random.default_rng(6)
    p_ranks, m_loc, n, r = 4, 16, 12, 3
    g = rng.standard_normal((p_ranks, m_loc, n)).astype(np.float32)
    q0 = rng.standard_normal((n, r)).astype(np.float32)
    (g_hat, _, stats), (jg, _, jstats) = _compress_both(
        g, _psgd_states(q0, p_ranks, m_loc, n, False), p_ranks,
        dict(rank=r, error_feedback=False, variant=variant), fault_spec={2: 1})
    _stats_equal(stats, jstats)
    plan = tc.make_plan(variant, p_ranks, tc.FaultSpec.of({2: 1}))
    assert np.array_equal(_np(stats["valid"]), plan.final_valid)
    if variant == "selfhealing":
        assert _np(stats["valid"]).all() and np.isfinite(_np(g_hat)).all()
    _close(g_hat, jg)


def test_powersgd_init_state():
    cfg = powersgd.PowerSGDConfig(rank=3)
    st = powersgd.init_state(torch.Generator().manual_seed(9), (10, 6), cfg, leading=(4,),
                             device="cpu")
    again = powersgd.init_state(torch.Generator().manual_seed(9), (10, 6), cfg, leading=(4,),
                                device="cpu")
    assert st["q"].shape == (4, 6, 3) and st["e"].shape == (4, 10, 6)
    assert all(torch.equal(st["q"][i], st["q"][0]) for i in range(4))   # one basis
    assert torch.equal(st["q"], again["q"]) and not st["e"].any()
    bare = powersgd.init_state(torch.Generator().manual_seed(9),
                               (10, 6), powersgd.PowerSGDConfig(rank=3, error_feedback=False),
                               device="cpu")
    assert bare["q"].shape == (6, 3) and bare["e"] is None
    want = jpsgd.init_state(jax.random.key(9), (10, 6), jpsgd.PowerSGDConfig(rank=3),
                            leading=(4,))
    assert jax.tree.map(np.shape, want) == {"q": (4, 6, 3), "e": (4, 10, 6)}


# ---------------------------------------------------------------------------
# Low-rank, ortho-momentum, CholeskyQR2
# ---------------------------------------------------------------------------

def test_lowrank_optimizer_state_compression(ref_sketch):
    rng = np.random.default_rng(8)
    w0 = rng.standard_normal((512, 512)).astype(np.float32)
    target = rng.standard_normal((512, 512)).astype(np.float32)
    jcfg = jlowrank.LowRankConfig(rank=16, min_dim=256, lr=1e-2)
    tcfg = lowrank.LowRankConfig(rank=16, min_dim=256, lr=1e-2)
    jp = {"w": jnp.asarray(w0), "b": jnp.zeros((512,), jnp.float32)}
    tp = {"w": _t(w0), "b": torch.zeros(512)}
    js, ts = jlowrank.init(jp, jcfg), lowrank.init(tp, tcfg)
    assert ts["per_param"]["w"]["m"].shape == (512, 16)       # 32× smaller
    assert ts["per_param"]["b"]["basis"] is None

    def grads(p, t):
        return {"w": 2 * (p["w"] - t) / (512 * 512), "b": 2 * p["b"] / 512}

    jt, tt = jnp.asarray(target), _t(target)
    l0 = float(np.mean((w0 - target) ** 2))
    for _ in range(30):
        jp, js = jlowrank.update(jcfg, jp, grads(jp, jt), js)
        tp, ts = lowrank.update(tcfg, tp, grads(tp, tt), ts)
    assert float(torch.mean((tp["w"] - tt) ** 2) + torch.mean(tp["b"] ** 2)) < l0
    _trees_close(tp, jp)
    _trees_close(ts["per_param"], js["per_param"])
    assert int(ts["step"]) == int(js["step"]) == 30


def test_orthosgd_update_is_orthogonal():
    m = np.random.default_rng(9).standard_normal((64, 16)).astype(np.float32)
    q = orthosgd._orth_update(_t(m))
    qn = _np(q) / np.sqrt(64 / 16)
    np.testing.assert_allclose(qn.T @ qn, np.eye(16), atol=1e-4)
    _close(q, jortho._orth_update(jnp.asarray(m)))
    _close(orthosgd._orth_update(_t(m.T), ft_shards=4), jortho._orth_update(jnp.asarray(m.T),
                                                                              ft_shards=4))


@pytest.mark.parametrize("ft_shards", [0, 4])
def test_orthosgd_minimizes(ft_shards):
    target = np.random.default_rng(10).standard_normal((32, 8)).astype(np.float32)
    jp, tp = {"w": jnp.zeros((32, 8))}, {"w": torch.zeros(32, 8)}
    jcfg = jortho.OrthoSGDConfig(lr=0.05, ft_shards=ft_shards)
    tcfg = orthosgd.OrthoSGDConfig(lr=0.05, ft_shards=ft_shards)
    js, ts = jortho.init(jp), orthosgd.init(tp)
    jt, tt = jnp.asarray(target), _t(target)
    for _ in range(40):
        jp, js = jortho.update(jcfg, jp, {"w": _mse_grads(jp, jt)}, js)
        tp, ts = orthosgd.update(tcfg, tp, {"w": _mse_grads(tp, tt)}, ts)
    assert float(torch.mean((tp["w"] - tt) ** 2)) < 0.5 * float(np.mean(target ** 2))
    _trees_close(tp, jp)
    _trees_close(ts["m"], js["m"])


def test_orthosgd_one_dimensional_params_take_momentum_sgd():
    rng = np.random.default_rng(11)
    p0, g0 = rng.standard_normal(5).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    jcfg = jortho.OrthoSGDConfig(lr=0.1, weight_decay=0.01)
    tcfg = orthosgd.OrthoSGDConfig(lr=0.1, weight_decay=0.01)
    jp, js = jortho.update(jcfg, {"b": jnp.asarray(p0)}, {"b": jnp.asarray(g0)},
                           jortho.init({"b": jnp.asarray(p0)}))
    tp, ts = orthosgd.update(tcfg, {"b": _t(p0)}, {"b": _t(g0)}, orthosgd.init({"b": _t(p0)}))
    _close(tp["b"], jp["b"], 1e-6)
    _close(ts["m"]["b"], js["m"]["b"], 0.0)


@pytest.mark.parametrize("shape", [(64, 12), (3, 50, 8)], ids=str)
def test_ft_cqr2_q_matches_dense(shape):
    """Sharded FT CholeskyQR2 is orthonormal, agrees with the dense CQR2
    (on batched and non-divisible inputs) and with the reference's."""
    a = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    q_ft = ft_cqr2_q(_t(a), shards=4)
    _close(q_ft, lowrank.gram_cqr2_q(_t(a)))
    _close(q_ft, j_ft_cqr2_q(jnp.asarray(a), shards=4))
    _close(lowrank.gram_cqr2_q(_t(a)), jlowrank.gram_cqr2_q(jnp.asarray(a)))
    for qi in _np(q_ft).reshape(-1, shape[-2], shape[-1]):
        np.testing.assert_allclose(qi.T @ qi, np.eye(shape[-1]), atol=1e-4)


@pytest.mark.parametrize("faults", [{2: 1}, {3: 1}, {0: 1, 2: 1}, {1: 2}], ids=str)
def test_ft_cqr2_q_under_a_faulted_plan(faults):
    """A death inside the Gram butterfly within tolerance: the plan is the
    reference's, and Q is still certified and equal to the dense CQR2."""
    a = np.random.default_rng(12).standard_normal((64, 12)).astype(np.float32)
    plan = tc.make_plan("redundant", 4, tc.FaultSpec.of(faults))
    jplan = jc.make_plan("redundant", 4, jc.FaultSpec.of(faults))
    assert np.array_equal(plan.final_valid, jplan.final_valid) and plan.final_valid.any()
    q = ft_cqr2_q(_t(a), shards=4, plan=plan)
    _close(q, lowrank.gram_cqr2_q(_t(a)))
    _close(q, j_ft_cqr2_q(jnp.asarray(a), shards=4, plan=jplan))


def test_ft_cqr2_q_raises_when_no_slot_holds_the_sum():
    a = np.random.default_rng(13).standard_normal((16, 4)).astype(np.float32)
    dead = {r: 0 for r in range(4)}
    plan = tc.make_plan("redundant", 4, tc.FaultSpec.of(dead))
    with pytest.raises(ValueError) as want:
        j_ft_cqr2_q(jnp.asarray(a), 4, plan=jc.make_plan("redundant", 4, jc.FaultSpec.of(dead)))
    with pytest.raises(ValueError, match=r"no shard slot holds the Gram sum") as got:
        ft_cqr2_q(_t(a), 4, plan=plan)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shards", [0, 1])
def test_ft_cqr2_q_one_shard_is_the_dense_cqr2(shards):
    a = _t(np.random.default_rng(14).standard_normal((20, 5)).astype(np.float32))
    assert torch.equal(ft_cqr2_q(a, shards), lowrank.gram_cqr2_q(a))


def test_gram_cqr2_rank_deficient_stays_finite():
    """The trace-scaled ridge keeps CholeskyQR2 finite on singular Gram
    matrices, and zero input maps to zero Q.  Q's degenerate columns are
    fixed by the ridge alone (condition ~1e6), so only the non-degenerate
    column is held to the reference."""
    col = np.random.default_rng(12).standard_normal((48, 1)).astype(np.float32)
    a = np.concatenate([col, col, np.zeros((48, 2), np.float32)], axis=1)
    for q in (lowrank.gram_cqr2_q(_t(a)), ft_cqr2_q(_t(a), shards=4)):
        assert bool(torch.isfinite(q).all()), "rank-deficient input made NaNs"
        _close(q[:, :1], jlowrank.gram_cqr2_q(jnp.asarray(a))[:, :1])
    assert float(lowrank.gram_cqr2_q(torch.zeros(16, 4)).abs().max()) == 0.0


def test_gram_cqr2_not_positive_definite_gives_nan_as_the_reference():
    a = np.full((8, 2), np.nan, np.float32)
    got, want = lowrank.gram_cqr2_q(_t(a)), jlowrank.gram_cqr2_q(jnp.asarray(a))
    assert np.array_equal(np.isnan(_np(got)), np.isnan(np.asarray(want)))


@pytest.mark.parametrize("m", [1300, 5200], ids=str)
def test_gram_past_a_block_sums_row_blocks(m):
    """Past ``GRAM_ROWS`` rows the Gram is a sum of row-block Grams, the
    last block zero-padded: within f32 rounding of float64, and CholeskyQR2
    through it (dense, and with 4 shards of 1300 rows at m = 5200) agrees
    with the reference's."""
    assert m > lowrank.GRAM_ROWS and m % lowrank.GRAM_ROWS
    a = np.random.default_rng(15).standard_normal((m, 24)).astype(np.float32)
    want = a.astype(np.float64).T @ a
    err = np.abs(_np(lowrank._gram(_t(a))).astype(np.float64) - want).max()
    assert err <= 1e-6 * np.abs(want).max(), err
    _close(lowrank.gram_cqr2_q(_t(a)), jlowrank.gram_cqr2_q(jnp.asarray(a)))
    _close(ft_cqr2_q(_t(a), shards=4), j_ft_cqr2_q(jnp.asarray(a), shards=4))


def test_a_nan_pivot_under_info_zero_is_a_refusal(monkeypatch):
    """cuSOLVER can factor a Gram indefinite by a few roundings with info 0
    and a NaN pivot: the factor is then all NaN, as after a refusal."""
    from repro_torch.kernels import ops

    factor = torch.linalg.cholesky_ex

    def nan_pivot(g):
        low, info = factor(g)
        low = low.clone()
        low[..., -1, -1] = float("nan")
        return low, info

    monkeypatch.setattr(torch.linalg, "cholesky_ex", nan_pivot)
    r = ops._chol_upper(torch.eye(3) * 2)
    upper = torch.ones(3, 3, dtype=torch.bool).triu()
    assert bool(torch.isnan(r[upper]).all()) and bool((r[~upper] == 0).all())


def _mean_grad_inputs():
    rng = np.random.default_rng(13)
    R, m, n, r = 4, 24, 10, 3
    u = rng.standard_normal((m, r)).astype(np.float32)
    v = rng.standard_normal((R, n, r)).astype(np.float32)
    g_rep = np.einsum("mr,Rnr->Rmn", u, v)                 # mean has rank <= r
    q0 = rng.standard_normal((n, r)).astype(np.float32)
    return g_rep, q0, r


@pytest.mark.parametrize("ft", [True, False])
def test_compress_mean_grad_exact_and_ft_parity(ft):
    """Exact on a rank-<=r mean gradient, FT path ≡ dense path within TOL,
    and both equal to the reference's; a masked replica (zero slot and
    n_live rescale) gives the survivors' mean."""
    g_rep, q0, r = _mean_grad_inputs()
    R = g_rep.shape[0]
    jcfg = jpsgd.PowerSGDConfig(rank=r, error_feedback=False)
    tcfg = powersgd.PowerSGDConfig(rank=r, error_feedback=False)
    got, got_q = powersgd.compress_mean_grad(_t(g_rep), _t(q0), cfg=tcfg, ft=ft)
    want, want_q = jpsgd.compress_mean_grad(jnp.asarray(g_rep), jnp.asarray(q0), cfg=jcfg, ft=ft)
    np.testing.assert_allclose(_np(got), g_rep.mean(0), rtol=2e-4, atol=2e-4)
    _close(got, want)
    _close(got_q, want_q)
    other, _ = powersgd.compress_mean_grad(_t(g_rep), _t(q0), cfg=tcfg, ft=not ft)
    _close(got, other)

    masked = g_rep.copy()
    masked[1] = 0.0
    got_s, _ = powersgd.compress_mean_grad(_t(masked), _t(q0), cfg=tcfg, ft=ft, n_live=R - 1.0)
    want_s, _ = jpsgd.compress_mean_grad(jnp.asarray(masked), jnp.asarray(q0), cfg=jcfg, ft=ft,
                                         n_live=jnp.float32(R - 1))
    np.testing.assert_allclose(_np(got_s), masked.sum(0) / (R - 1), rtol=2e-4, atol=2e-4)
    _close(got_s, want_s)


@pytest.mark.parametrize("faults", [{1: 1}, {0: 1, 2: 1}, {3: 2}], ids=str)
def test_compress_mean_grad_under_a_death(faults):
    """A replica slot dies inside the two means: the plan is the
    reference's and ĝ is read from a certified slot on both sides."""
    g_rep, q0, r = _mean_grad_inputs()
    plan = tc.make_plan("redundant", 4, tc.FaultSpec.of(faults))
    jplan = jc.make_plan("redundant", 4, jc.FaultSpec.of(faults))
    assert np.array_equal(plan.final_valid, jplan.final_valid)
    got, _ = powersgd.compress_mean_grad(_t(g_rep), _t(q0), plan=plan,
                                         cfg=powersgd.PowerSGDConfig(rank=r))
    want, _ = jpsgd.compress_mean_grad(jnp.asarray(g_rep), jnp.asarray(q0), plan=jplan,
                                       cfg=jpsgd.PowerSGDConfig(rank=r))
    _close(got, want)
    np.testing.assert_allclose(_np(got), g_rep.mean(0), rtol=2e-4, atol=2e-4)


def test_compress_mean_grad_raises_when_no_slot_holds_the_mean():
    g_rep, q0, r = _mean_grad_inputs()
    dead = {k: 0 for k in range(4)}
    with pytest.raises(ValueError) as want:
        jpsgd.compress_mean_grad(jnp.asarray(g_rep), jnp.asarray(q0),
                                 cfg=jpsgd.PowerSGDConfig(rank=r),
                                 plan=jc.make_plan("redundant", 4, jc.FaultSpec.of(dead)))
    with pytest.raises(ValueError) as got:
        powersgd.compress_mean_grad(_t(g_rep), _t(q0), cfg=powersgd.PowerSGDConfig(rank=r),
                                    plan=tc.make_plan("redundant", 4, tc.FaultSpec.of(dead)))
    assert str(got.value) == str(want.value)


def test_state_from_reference_keeps_structure_and_bits():
    rng = np.random.default_rng(15)
    ref = {"per_param": {"w": {"m": rng.standard_normal((4, 2)).astype(np.float32),
                               "basis": None}},
           "pair": (np.arange(3, dtype=np.int32), [np.float32(2.5)]),
           "step": np.asarray(7, np.int32)}
    got = state_from_reference(jax.tree.map(jnp.asarray, ref), "cpu")
    assert got["per_param"]["w"]["basis"] is None
    assert isinstance(got["pair"], tuple) and isinstance(got["pair"][1], list)
    assert torch.equal(got["per_param"]["w"]["m"], _t(ref["per_param"]["w"]["m"]))
    assert got["pair"][0].dtype == torch.int32 and got["step"].dtype == torch.int32
    assert int(got["step"]) == 7 and got["step"].device.type == "cpu"
