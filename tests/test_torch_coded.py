"""The port's checksum-coded collective against the JAX package's on the
same inputs: plans field by field (including the unrecoverable verdicts,
ROADMAP C2), ``coded_allreduce`` values, validity and detection for every
inner combiner, and the port's own contracts: fault-free coded ≡ the
redundant butterfly bit for bit, decode within ``reconstruction_tol``,
exact detection, honest degradation and exact wire accounting."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from coded_parity import assert_plans_equal, spec  # noqa: E402
from repro import collective as jc  # noqa: E402

from repro_torch import collective as tc  # noqa: E402

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover — optional extra
    st = None


def _mixes(p, c):
    """Deterministic fault mixes ``(deaths, slow, corrupt)`` for P data and
    c parity ranks: fault-free, single erasures of each kind, a mix within
    budget, an over-budget set, a dead gather root, unusable parity lanes,
    and (for P <= c) every data rank dead — the no-survivor verdict."""
    w = p + c
    out = [((), (), ()), ((0,), (), ()), ((), (p - 1,), ()), ((), (), (p // 2,))]
    if p >= 3:
        out.append(((0,), (1,), (2,)))
    if p > c:
        out.append((tuple(range(c + 1)), (), ()))                  # over budget
    out.append((tuple(range(min(c, p))), (), ()))                   # P <= c: no survivor
    out.append(((p,), (), (0,) if p > 1 else ()))                   # a dead parity rank
    out.append(((), (w - 1,), (p - 1,)))                            # a slow parity rank
    out.append(((), (), (w - 1, 0)))                                # a corrupt parity rank
    return out


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("p", range(1, 9))
def test_plans_equal_reference(p, c):
    for deaths, slow, corrupt in _mixes(p, c):
        want = jc.make_coded_plan(p, c, spec(jc.FaultSpec, deaths, slow, corrupt))
        got = tc.make_coded_plan(p, c, spec(tc.FaultSpec, deaths, slow, corrupt))
        assert_plans_equal(got, want)
        again = tc.make_coded_plan(p, c, spec(tc.FaultSpec, deaths, slow, corrupt))
        assert got == again and hash(got) == hash(again)
    assert tc.make_coded_plan(p, c) != tc.make_coded_plan(p, c, spec(tc.FaultSpec, (0,)))
    assert tc.reconstruction_tol(np.float32) == jc.reconstruction_tol(np.float32)
    assert tc.reconstruction_tol(torch.float32) == jc.reconstruction_tol(np.float32)
    np.testing.assert_array_equal(tc.coded_weights(p, c), jc.coded_weights(p, c))


def test_planner_refusals_equal_reference():
    for args in [(0, 1), (2, 0)]:
        with pytest.raises(ValueError) as want:
            jc.make_coded_plan(*args)
        with pytest.raises(ValueError, match=str(want.value).split(",")[0]):
            tc.make_coded_plan(*args)
    with pytest.raises(ValueError, match=r"corrupt ranks \[9\] out of range for W=6"):
        tc.make_coded_plan(4, 2, tc.FaultSpec.of({}, corrupt=(9,)))


# ---------------------------------------------------------------------------
# coded_allreduce against the reference
# ---------------------------------------------------------------------------

OPS = ["sum", "mean", "max", "gram_sum", "qr_combine", "stacked"]


def _payload(rng, op, p):
    if op == "qr_combine":
        return rng.standard_normal((p, 12, 4)).astype(np.float32)
    if op == "gram_sum":
        x = rng.standard_normal((p, 10, 5)).astype(np.float32)
        return np.einsum("pmi,pmj->pij", x, x)
    if op == "stacked":
        return (rng.standard_normal((p, 4, 4)).astype(np.float32),
                rng.standard_normal((p, 4, 6)).astype(np.float32))
    return rng.standard_normal((p, 3, 5)).astype(np.float32)


def _combiners(op):
    if op == "stacked":
        return jc.stacked("qr_combine", "sum"), tc.stacked("qr_combine", "sum")
    return op, op


def _as(x, mod, dt):
    if isinstance(x, tuple):
        return tuple(_as(v, mod, dt) for v in x)
    if mod is jnp:
        return jnp.asarray(x, dtype=getattr(jnp, dt))
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dt))


def _leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


def _f32(leaf):
    return np.asarray(leaf.float() if isinstance(leaf, torch.Tensor) else leaf.astype(jnp.float32))


FAULTS = {"none": ((), (), ()), "deaths": ((0, 2), (), ()), "mixed": ((1,), (4,), (6,)),
          "over": ((0, 3, 5), (), ())}


# Householder QR has no bfloat16 kernel in either package
OP_DTYPES = [(op, dt) for op in OPS for dt in ("float32", "bfloat16")
             if dt == "float32" or op not in ("qr_combine", "stacked")]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("op,dt", OP_DTYPES)
def test_coded_allreduce_matches_reference(rng, op, dt, fault):
    p, c = 8, 2 if fault != "mixed" else 3
    deaths, slow, corrupt = FAULTS[fault]
    if dt == "bfloat16":
        # the reference's verify asks numpy for bfloat16's finfo, which
        # numpy refuses, so no bf16 rank is declared corrupt here
        corrupt = ()
    x = _payload(rng, op, p)
    observed = tuple(v.copy() for v in x) if isinstance(x, tuple) else x.copy()
    for leaf in _leaves(observed):
        leaf[list(corrupt)] *= 3.0
    jop, top = _combiners(op)
    jval, jvalid, jdet = jc.coded_allreduce(
        _as(x, jnp, dt), jc.SimComm(p + c), op=jop, n_parity=c,
        fault_spec=spec(jc.FaultSpec, deaths, slow, corrupt), observed=_as(observed, jnp, dt))
    val, valid, det = tc.coded_allreduce(
        _as(x, torch, dt), tc.SimComm(p + c, "cpu"), op=top, n_parity=c,
        fault_spec=spec(tc.FaultSpec, deaths, slow, corrupt), observed=_as(observed, torch, dt))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))
    erased = bool(deaths or slow or corrupt)
    tol = 3e-2 if dt == "bfloat16" else 5e-4
    if erased:
        tol = max(tol, tc.reconstruction_tol(getattr(torch, dt)))
    for got, want in zip(_leaves(val), _leaves(jval)):
        got, want = _f32(got), _f32(want)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        rows = valid.numpy()
        if rows.any():
            scale = max(1.0, np.abs(want[rows]).max())
            assert np.abs(got[rows] - want[rows]).max() / scale <= tol


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("op", OPS)
def test_fault_free_bitwise_equals_butterfly(rng, op, c):
    p = 8
    x = _as(_payload(rng, op, p), torch, "float32")
    top = _combiners(op)[1]
    ref, _ = tc.ft_allreduce(x, tc.SimComm(p, "cpu"), op=top, variant="redundant")
    comm = tc.InstrumentedComm(tc.SimComm(p + c, "cpu"))
    val, valid, det = tc.coded_allreduce(x, comm, op=top, n_parity=c)
    for got, want in zip(_leaves(val), _leaves(ref)):
        assert torch.equal(got[:p], want)
    assert bool(valid.all()) and not bool(det.any())
    plan = tc.make_coded_plan(p, c)
    assert comm.stats.messages == plan.message_count() == 17 - 3 + c
    assert comm.stats.payload_bytes == plan.bytes_on_wire_stacked(
        [tuple(v.shape[1:]) + (4, op == "gram_sum") for v in _leaves(x)]
        if op != "qr_combine" else [(4, 4, 4, False)])


def _truth(x, op):
    t = x.astype(np.float64).sum(0)
    return t / x.shape[0] if op == "mean" else t


@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_decode_within_documented_bound(op, dt, c):
    p = 8
    x = np.random.default_rng(c).standard_normal((p, 4, 3)).astype(dt)
    dead = tuple(range(0, 2 * c, 2))[:c]                  # includes the root
    plan = tc.make_coded_plan(p, c, spec(tc.FaultSpec, dead))
    val, valid, det = tc.coded_allreduce(torch.from_numpy(x), tc.SimComm(p + c, "cpu"), op=op, plan=plan)
    assert plan.n_erased == c and bool(valid[:p].all()) and not bool(det.any())
    truth = _truth(x, op)
    err = np.abs(val[0].double().numpy() - truth).max() / max(1.0, np.abs(truth).max())
    assert err <= tc.reconstruction_tol(val.dtype)


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_mixed_erasures_and_detection(dt):
    p, c = 8, 3
    x = np.random.default_rng(7).standard_normal((p, 4, 3)).astype(dt)
    observed = x.copy()
    observed[6] *= 3.0
    plan = tc.make_coded_plan(p, c, spec(tc.FaultSpec, (1,), (4,), (6,)))
    comm = tc.InstrumentedComm(tc.SimComm(p + c, "cpu"))
    val, valid, det = tc.coded_allreduce(torch.from_numpy(x), comm, op="sum", plan=plan,
                                         observed=torch.from_numpy(observed))
    truth = _truth(x, "sum")
    err = np.abs(val[0].double().numpy() - truth).max() / max(1.0, np.abs(truth).max())
    assert err <= tc.reconstruction_tol(val.dtype)
    assert bool(valid[:p].all())
    assert np.flatnonzero(det.numpy()).tolist() == [6]
    assert comm.stats.messages == plan.message_count()
    assert comm.stats.payload_bytes == plan.bytes_on_wire_stacked(
        [(4, 3, val.element_size(), False)])


def test_unperturbed_corrupt_rank_is_reconstructed_not_flagged():
    p, c = 8, 2
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((p, 4, 3)).astype(np.float32))
    val, valid, det = tc.coded_allreduce(x, tc.SimComm(p + c, "cpu"), n_parity=c,
                                         fault_spec=spec(tc.FaultSpec, corrupt=(5,)))
    assert bool(valid.all()) and not bool(det.any())
    torch.testing.assert_close(val[0], x.sum(0), rtol=0, atol=1e-5)


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_over_budget_degrades_honestly(op):
    p, c = 8, 2
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((p, 4, 3)).astype(np.float32))
    plan = tc.make_coded_plan(p, c, spec(tc.FaultSpec, (0, 3, 5)))
    comm = tc.InstrumentedComm(tc.SimComm(p + c, "cpu"))
    val, valid, _ = tc.coded_allreduce(x, comm, op=op, plan=plan)
    assert not plan.recoverable and not bool(valid.any())
    assert bool(torch.isnan(val).all())
    assert comm.stats.messages == 0 and plan.message_count() == 0


def test_integer_payload_rejected():
    x = torch.arange(16, dtype=torch.int32).reshape(4, 4)
    with pytest.raises(TypeError, match="inexact"):
        tc.coded_allreduce(x, tc.SimComm(5, "cpu"), n_parity=1)


def test_payload_rows_must_match_the_world():
    with pytest.raises(ValueError, match="matches neither P=4 nor W=5"):
        tc.coded_allreduce(torch.zeros(3, 2), tc.SimComm(5, "cpu"), n_parity=1)
    with pytest.raises(ValueError, match="comm has 6 ranks"):
        tc.execute_coded(torch.zeros(4, 2), tc.SimComm(6, "cpu"), tc.make_coded_plan(4, 1), "sum")
    # a (W,)-leading payload: its parity rows are recomputed
    x = torch.ones(5, 2)
    x[4] = 99.0
    val, _, _ = tc.coded_allreduce(x, tc.SimComm(5, "cpu"), n_parity=1,
                                   fault_spec=spec(tc.FaultSpec, (1,)))
    torch.testing.assert_close(val[0], torch.full((2,), 4.0))


def test_wire_accounting_exact_across_fault_mixes():
    p, c = 8, 3
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((p, 4, 3)).astype(np.float32))
    g = torch.from_numpy(_payload(rng, "gram_sum", p))
    mixes = [((), (), ()), ((2,), (), ()), ((), (1, 5), ()), ((0,), (), (7,))]
    for deaths, slow, corrupt in mixes:
        for payload, op, leaves in ((x, "sum", [(4, 3, 4, False)]),
                                    (g, "gram_sum", [(5, 5, 4, True)])):
            plan = tc.make_coded_plan(p, c, spec(tc.FaultSpec, deaths, slow, corrupt))
            comm = tc.InstrumentedComm(tc.SimComm(p + c, "cpu"))
            tc.coded_allreduce(payload, comm, op=op, plan=plan)
            assert comm.stats.messages == plan.message_count()
            assert comm.stats.payload_bytes == plan.bytes_on_wire_stacked(leaves)
            assert comm.stats.rounds == plan.round_count()


def test_recover_payload_coded_branch():
    plan = tc.make_coded_plan(4, 2, spec(tc.FaultSpec, (1,)))
    x = torch.ones(4, 2)
    assert tc.recover_payload(x, tc.SimComm(4, "cpu"), plan.final_valid, plan=plan) is x
    bad = tc.make_coded_plan(4, 1, spec(tc.FaultSpec, (0, 1)))
    with pytest.raises(ValueError) as want:
        jc.recover_payload(jnp.ones((4, 2)), jc.SimComm(4), bad.final_valid,
                           plan=jc.make_coded_plan(4, 1, spec(jc.FaultSpec, (0, 1))))
    with pytest.raises(ValueError, match=str(want.value)[:60]):
        tc.recover_payload(x, tc.SimComm(4, "cpu"), bad.final_valid, plan=bad)


if st is not None:
    @settings(max_examples=25, derandomize=True, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(data=st.data(), p=st.integers(min_value=2, max_value=8),
           c=st.integers(min_value=1, max_value=3), op=st.sampled_from(["sum", "mean"]))
    def test_random_fault_mix_sweep(data, p, c, op):
        """Random disjoint death / slow / corrupt mixes over the data ranks:
        the plan equals the reference's; within budget and with a data
        survivor left the result decodes and detection is exact; otherwise
        (over budget, or every data rank erased — ROADMAP C2) nothing is
        valid and every payload is NaN.  Wire accounting holds either way."""
        x = np.random.default_rng(p * 10 + c).standard_normal((p, 4, 3)).astype(np.float32)
        n_faults = data.draw(st.integers(min_value=0, max_value=min(c + 1, p)), label="l")
        ranks = data.draw(st.permutations(range(p)).map(lambda s: s[:n_faults]), label="ranks")
        kinds = data.draw(st.lists(st.sampled_from(["death", "slow", "corrupt"]),
                                   min_size=n_faults, max_size=n_faults), label="kinds")
        dead = tuple(r for r, k in zip(ranks, kinds) if k == "death")
        slow = tuple(r for r, k in zip(ranks, kinds) if k == "slow")
        corrupt = tuple(r for r, k in zip(ranks, kinds) if k == "corrupt")
        observed = x.copy()
        observed[list(corrupt)] *= 3.0
        plan = tc.make_coded_plan(p, c, spec(tc.FaultSpec, dead, slow, corrupt))
        assert_plans_equal(plan, jc.make_coded_plan(p, c, spec(jc.FaultSpec, dead, slow, corrupt)))
        comm = tc.InstrumentedComm(tc.SimComm(p + c, "cpu"))
        val, valid, det = tc.coded_allreduce(torch.from_numpy(x), comm, op=op, plan=plan,
                                             observed=torch.from_numpy(observed))
        assert comm.stats.messages == plan.message_count()
        assert comm.stats.payload_bytes == plan.bytes_on_wire_stacked([(4, 3, 4, False)])
        if n_faults <= c and n_faults < p:
            truth = _truth(x, op)
            err = np.abs(val[0].double().numpy() - truth).max() / max(1.0, np.abs(truth).max())
            assert plan.recoverable and bool(valid[:p].all())
            assert err <= tc.reconstruction_tol(torch.float32)
            assert np.flatnonzero(det[:p].numpy()).tolist() == sorted(corrupt)
        else:
            assert not plan.recoverable
            assert not bool(valid.any()) and bool(torch.isnan(val).all())
