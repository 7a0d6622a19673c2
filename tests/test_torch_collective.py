"""The port's collective layer against the JAX package's on the same inputs:
plans field by field, ``execute_plan`` / ``ft_allreduce`` on SimComm for
every variant × combiner × fault picture (values within tolerance, validity
and NaN positions equal), exchange counters, and the port's own fast-path ≡
general-executor contract."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from repro import collective as jc  # noqa: E402

from repro_torch import collective as tc  # noqa: E402

VARIANTS = ("tree", "redundant", "replace", "selfhealing")

# (P, deaths) pictures: fault-free, one death per step, a within-tolerance
# pair, a cascade beyond tolerance, and a block wipe.
SPECS = {
    2: [{}, {0: 0}, {1: 1}],
    4: [{}, {2: 1}, {0: 0}, {1: 1, 3: 1}, {0: 1, 1: 1}],
    8: [{}, {5: 1}, {3: 2}, {0: 0}, {1: 1, 6: 2}, {2: 2, 3: 2, 7: 2}, {4: 1, 5: 1}],
}
CASES = [(p, d) for p, ds in SPECS.items() for d in ds]


def _specs(deaths):
    return jc.FaultSpec.of(deaths), tc.FaultSpec.of(deaths)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("p", sorted(SPECS))
def test_plans_equal_reference(variant, p):
    for deaths in SPECS[p]:
        js, ts = _specs(deaths)
        want = jc.make_plan(variant, p, js)
        got = tc.make_plan(variant, p, ts)
        assert got.variant == want.variant and got.n_ranks == want.n_ranks
        assert got.n_steps == want.n_steps
        np.testing.assert_array_equal(got.death, want.death)
        np.testing.assert_array_equal(got.final_valid, want.final_valid)
        assert len(got.steps) == len(want.steps)
        for gs, ws in zip(got.steps, want.steps):
            assert gs.level == ws.level
            assert gs.perm_rounds == ws.perm_rounds
            assert gs.restore_rounds == ws.restore_rounds
            np.testing.assert_array_equal(gs.valid_after, ws.valid_after)
            np.testing.assert_array_equal(gs.respawned, ws.respawned)
        assert got.is_fault_free == want.is_fault_free
        assert got.message_count() == want.message_count()
        assert got.round_count() == want.round_count()
        for n in (3, 16):
            assert got.bytes_on_wire(n) == want.bytes_on_wire(n)
            assert got.bytes_on_wire(n, symmetric=True) == want.bytes_on_wire(n, symmetric=True)
        leaves = [(4, 4, 4, True), (4, 6, 4, False)]
        assert got.bytes_on_wire_stacked(leaves) == want.bytes_on_wire_stacked(leaves)
        assert tc.within_tolerance(variant, ts, got.n_steps) == jc.within_tolerance(
            variant, js, want.n_steps
        )
        assert tc.total_tolerance(variant, got.n_steps) == jc.total_tolerance(
            variant, want.n_steps
        )
        # value identity: an equal plan hashes equal, a different one differs
        assert got == tc.make_plan(variant, p, tc.FaultSpec.of(deaths))
        assert hash(got) == hash(tc.make_plan(variant, p, tc.FaultSpec.of(deaths)))


def _payload(rng, op, p):
    if op == "qr":
        return rng.standard_normal((p, 12, 4)).astype(np.float32)
    if op == "gram_sum":
        x = rng.standard_normal((p, 10, 5)).astype(np.float32)
        return np.einsum("pmi,pmj->pij", x, x)
    return rng.standard_normal((p, 3, 5)).astype(np.float32)


def _check_equal_semantics(got, got_valid, want, want_valid, plan):
    want_valid = np.asarray(want_valid)
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    np.testing.assert_array_equal(got_valid.numpy(), plan.final_valid)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = want_valid
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "gram_sum", "qr"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_ft_allreduce_matches_reference(rng, op, variant):
    for p, deaths in CASES:
        x = _payload(rng, op, p)
        js, ts = _specs(deaths)
        want, want_valid = jc.ft_allreduce(
            jnp.asarray(x), jc.SimComm(p), op=op, variant=variant, fault_spec=js
        )
        plan = tc.make_plan(variant, p, ts)
        got, got_valid = tc.ft_allreduce(
            torch.from_numpy(x), tc.SimComm(p, "cpu"), op=op, plan=plan
        )
        _check_equal_semantics(got, got_valid, want, want_valid, plan)


@pytest.mark.parametrize("variant", VARIANTS)
def test_stacked_payload_matches_reference(rng, variant):
    for p, deaths in CASES:
        r = _payload(rng, "gram_sum", p)
        c = _payload(rng, "sum", p)
        js, ts = _specs(deaths)
        (wr, wc), wv = jc.execute_plan(
            (jnp.asarray(r), jnp.asarray(c)), jc.SimComm(p),
            jc.make_plan(variant, p, js), jc.stacked("gram_sum", "sum"),
        )
        plan = tc.make_plan(variant, p, ts)
        (gr, gc), gv = tc.execute_plan(
            (torch.from_numpy(r), torch.from_numpy(c)), tc.SimComm(p, "cpu"), plan,
            tc.stacked("gram_sum", "sum"),
        )
        _check_equal_semantics(gr, gv, wr, wv, plan)
        _check_equal_semantics(gc, gv, wc, wv, plan)


@pytest.mark.parametrize("op", ["sum", "max", "gram_sum", "qr"])
@pytest.mark.parametrize("fast", [None, False])
def test_instrumented_counts_match_reference(rng, op, fast):
    for p, deaths in CASES:
        x = _payload(rng, op, p)
        for variant in VARIANTS:
            js, ts = _specs(deaths)
            jcomm = jc.InstrumentedComm(jc.SimComm(p))
            tcomm = tc.InstrumentedComm(tc.SimComm(p, "cpu"))
            jc.execute_plan(jnp.asarray(x), jcomm, jc.make_plan(variant, p, js), op, fast=fast)
            tc.execute_plan(torch.from_numpy(x), tcomm, tc.make_plan(variant, p, ts), op,
                            fast=fast)
            assert tcomm.stats.per_round == jcomm.stats.per_round
            assert tcomm.stats.as_dict() == jcomm.stats.as_dict()


@pytest.mark.parametrize("op", ["sum", "mean", "max", "gram_sum", "qr"])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_fast_path_bitwise_equals_general_executor(rng, op, p):
    x = torch.from_numpy(_payload(rng, op, p))
    for variant in ("redundant", "replace", "selfhealing"):
        plan = tc.make_plan(variant, p)
        assert plan.is_fault_free
        fast, fv = tc.execute_plan(x, tc.SimComm(p, "cpu"), plan, op, fast=True)
        slow, sv = tc.execute_plan(x, tc.SimComm(p, "cpu"), plan, op, fast=False)
        assert torch.equal(fast, slow) and torch.equal(fv, sv)


def test_fast_true_on_faulty_plan_raises():
    plan = tc.make_plan("redundant", 4, tc.FaultSpec.of({1: 1}))
    with pytest.raises(ValueError, match="fault-free"):
        tc.execute_plan(torch.zeros(4, 2), tc.SimComm(4, "cpu"), plan, "sum", fast=True)


def test_exchange_zero_fills_and_caches_indices():
    comm = tc.SimComm(4, "cpu")
    x = torch.arange(1.0, 5.0)
    out = comm.exchange(x, [(0, 1), (2, 3)])
    assert out.tolist() == [0.0, 1.0, 0.0, 3.0]
    assert comm.exchange(x, []).tolist() == [0.0] * 4
    from repro_torch.collective.comm import _perm_index

    idx = _perm_index(((0, 1), (2, 3)), torch.device("cpu"))
    assert idx is _perm_index(((0, 1), (2, 3)), torch.device("cpu"))
    assert comm.take(np.array([1, 0, 1, 0], bool)) is comm.take(np.array([1, 0, 1, 0], bool))


def test_pack_unpack_round_trip_matches_reference(rng):
    x = _payload(rng, "gram_sum", 3)
    x[1] = np.nan
    packed = tc.pack_sym(torch.from_numpy(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jc.pack_sym(jnp.asarray(x))))
    back = tc.unpack_sym(packed, 5).numpy()
    np.testing.assert_array_equal(back, np.asarray(jc.unpack_sym(jc.pack_sym(jnp.asarray(x)), 5)))
    np.testing.assert_array_equal(back[0], x[0])


@pytest.mark.parametrize("variant", ["redundant", "replace"])
def test_replica_fetch_matches_reference(rng, variant):
    p, deaths = 8, {5: 1}
    x = _payload(rng, "sum", p)
    js, ts = _specs(deaths)
    jplan, tplan = jc.make_plan(variant, p, js), tc.make_plan(variant, p, ts)
    jv, jvalid = jc.ft_allreduce(jnp.asarray(x), jc.SimComm(p), plan=jplan)
    tv, tvalid = tc.ft_allreduce(torch.from_numpy(x), tc.SimComm(p, "cpu"), plan=tplan)
    want = jc.recover_payload(jv, jc.SimComm(p), jplan.final_valid, plan=jplan)
    got = tc.recover_payload(tv, tc.SimComm(p, "cpu"), tplan.final_valid, plan=tplan)
    assert not np.isnan(got.numpy()).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="no valid rank"):
        tc.replica_fetch(tv, tc.SimComm(p, "cpu"), np.zeros(p, bool))


def test_simcomm_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.SimComm(4)
    comm = tc.SimComm(4, "cpu")
    assert comm.device.type == "cpu"
    assert tc.InstrumentedComm(comm).device == comm.device


@pytest.mark.parametrize("call", ["ft_allreduce", "execute_plan_general", "replica_fetch",
                                  "coded_allreduce"])
def test_payload_off_the_comm_device_raises(call):
    x = torch.zeros(4, 2, device="meta")
    comm = tc.InstrumentedComm(tc.SimComm(4, "cpu"))
    faulty = tc.make_plan("redundant", 4, tc.FaultSpec.of({1: 1}))
    run = {
        "ft_allreduce": lambda: tc.ft_allreduce(x, comm),
        "execute_plan_general": lambda: tc.execute_plan(x, comm, faulty, "sum"),
        "replica_fetch": lambda: tc.replica_fetch(x, comm, np.array([1, 0, 1, 1], bool)),
        "coded_allreduce": lambda: tc.coded_allreduce(x[:3], comm, n_parity=1),
    }[call]
    with pytest.raises(ValueError, match="comm's per-rank vectors are on cpu"):
        run()
    assert comm.stats.rounds == 0
