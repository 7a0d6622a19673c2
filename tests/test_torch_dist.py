"""The port's ``DistComm`` (one process per rank) against the reference's
``ShardMapComm`` under ``shard_map``, on the cases of the reference's own
SPMD tests (``tests/test_spmd.py:212``, ``:281``).

The port's side runs in one world of 8 CPU ranks over gloo, the
reference's in a subprocess with 8 forced host devices; both once per
test session, shared with ``test_torch_dist_qr.py``
(``dist_parity.both_sides``).  Held exactly: validity bits, NaN
poisoning, the message, round and byte counts, the ``track_dispatch``
dicts and the error messages.  Held within ``TOL`` (``tests/
test_torch_tsqr.py``'s) against the reference: values.  Held within the
port: the fast path ≡ the general executor, and ``ft_allreduce_jit`` on
the mesh ≡ its SimComm program, bit for bit, as the reference asserts of
its two backends.  The unit tests of ``DistComm`` run in this process on
a world of one rank.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from repro.collective import ShardMapComm as JShardMapComm  # noqa: E402
from repro.collective import execute_coded as jexecute_coded  # noqa: E402
from repro.collective import make_coded_plan as jmake_coded_plan  # noqa: E402

import dist_parity as dp  # noqa: E402
from repro_torch.collective import (  # noqa: E402
    DistComm,
    FaultSpec,
    ShardMapComm,
    execute_coded,
    make_coded_plan,
    make_plan,
)
from repro_torch import replay  # noqa: E402
from repro_torch.collective import dist, ft_allreduce_jit  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.qr import QRConfig, factorize  # noqa: E402

TOL = dict(rtol=5e-4, atol=5e-4)
AR_CASES = [(op, v, None) for op in dp.OPS for v in dp.VARIANTS] + [
    (op, v, dp.DEATHS) for op in dp.OPS for v in dp.FAULTED]


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return dp.both_sides(tmp_path_factory, "allreduce")


def _assert_rows(got_rows, want, valid):
    """Each rank's row against the reference's: NaN where it has NaN, and
    within TOL on the valid ranks."""
    got = np.stack(got_rows)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    for r in np.flatnonzero(valid):
        np.testing.assert_allclose(got[r], want[r], **TOL)


@pytest.mark.parametrize("op,variant,deaths", AR_CASES,
                         ids=[f"{o}-{v}-{dp._key(d)}" for o, v, d in AR_CASES])
def test_ft_allreduce_matches_reference(sides, op, variant, deaths):
    port, ref = sides
    key = ("ar", op, variant, dp._key(deaths))
    plan = make_plan(variant, dp.P, FaultSpec.of(deaths) if deaths else None)
    ok = np.array([out[key][1] for out in port])
    np.testing.assert_array_equal(ok, ref[key][1])
    np.testing.assert_array_equal(ok, plan.final_valid)
    _assert_rows([out[key][0] for out in port], ref[key][0], plan.final_valid)


@pytest.mark.parametrize("op", dp.FAST_OPS)
@pytest.mark.parametrize("variant", dp.VARIANTS)
def test_fast_path_equals_general_executor(sides, op, variant):
    port, ref = sides
    key = ("fast", op, variant)
    for out in port:
        va, oa, vg, og, fault_free = out[key]
        assert np.array_equal(va, vg, equal_nan=True) and oa == og
        assert fault_free == (variant != "tree")
    _assert_rows([out[key][0] for out in port], ref[key][0], ref[key][1])


@pytest.mark.parametrize("case", dp.COUNTED, ids=lambda c: f"{c[0]}-{c[1]}-{dp._key(c[2])}")
def test_instrumented_counts_match_reference(sides, case):
    """Every rank counts the whole round, priced by its local block: each
    rank's counters equal the reference's."""
    port, ref = sides
    key = ("count", case[0], case[1], dp._key(case[2]))
    assert ref[key]["messages"] > 0
    for out in port:
        assert out[key] == ref[key]


def test_exchange_sends_one_message_a_pair(sides):
    port, _ = sides
    x = dp.allreduce_inputs()["x"]
    for r, out in enumerate(port):
        got, got_bit, empty, empty_bit = out["exchange"]
        src = {1: 0, 3: 2}.get(r)
        if src is None:
            assert not got.any() and not got_bit
        else:
            np.testing.assert_array_equal(got, x[src])
            assert got_bit
        assert not empty.any() and not empty_bit


@pytest.mark.parametrize("op", ["sum", "gram_sum"])
def test_ft_allreduce_jit_on_the_mesh_equals_simcomm(sides, op):
    port, ref = sides
    key = ("jit", op)
    for out in port:
        vm, okm, vs, oks, d = out[key]
        assert np.array_equal(vm, vs) and np.array_equal(okm, oks)
        assert d == ref[key][4] == {"traces": {"ft_allreduce": 1},
                                    "dispatches": {"ft_allreduce": 1},
                                    "rounds": {}, "overlapped": {}}
    np.testing.assert_allclose(dp.gather(port, lambda o: o[key][0]), ref[key][0], **TOL)
    np.testing.assert_array_equal(dp.gather(port, lambda o: o[key][1]), ref[key][1])


def test_ft_allreduce_jit_faulted_plan(sides):
    port, ref = sides
    plan = make_plan("redundant", dp.P, FaultSpec.of(dp.DEATHS))
    for out in port:
        vm, okm, vs, oks = out["jit_faulted"]
        assert np.array_equal(vm, vs, equal_nan=True) and np.array_equal(okm, oks)
    ok = dp.gather(port, lambda o: o["jit_faulted"][1])
    np.testing.assert_array_equal(ok, plan.final_valid)
    np.testing.assert_array_equal(ok, ref["jit_faulted"][1])
    _assert_rows([o["jit_faulted"][0][0] for o in port], ref["jit_faulted"][0], ok)


def test_ft_allreduce_jit_warm_repeat_traces_nothing(sides):
    port, ref = sides
    for out in port:
        assert out["jit_warm"] == ref["jit_warm"]
        assert out["jit_warm"][0] == 0


def test_ft_allreduce_jit_mesh_errors_match_reference(sides):
    port, ref = sides
    assert set(ref["jit_errors"]) == {"no_mesh", "size", "axis"}
    for out in port:
        assert out["jit_errors"] == ref["jit_errors"]


# ---------------------------------------------------------------------------
# Unit tests on a world of one rank, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank():
    with dist.local_mesh("rows", "cpu") as mesh:
        yield mesh, DistComm(1, "rows", mesh.group)


def test_one_rank_take_bwhere_and_leaf_nbytes(one_rank):
    mesh, comm = one_rank
    assert ShardMapComm is DistComm and comm.device == torch.device("cpu")
    assert comm.rank == 0 and mesh.rank == 0 and mesh.shape == {"rows": 1}
    assert comm.ranks().shape == () and int(comm.ranks()) == 0
    bit = comm.take(np.array([True]))
    assert bit.shape == () and bool(bit)
    assert int(comm.take(np.array([7], np.int32))) == 7
    with pytest.raises(ValueError, match=r"\(1,\) host vector"):
        comm.take(np.array([True, False]))
    a, b = torch.ones(2, 3), torch.zeros(2, 3)
    assert torch.equal(comm.bwhere(bit, a, b), a)
    assert torch.equal(comm.bwhere(~bit, a, b), b)
    assert comm.leaf_nbytes(torch.zeros(2, 3)) == 24
    assert comm.leaf_nbytes(torch.zeros((), dtype=torch.bool)) == 1


def test_one_rank_empty_perm_gives_zeros(one_rank):
    _, comm = one_rank
    x = (torch.ones(2, 3), torch.tensor(True), [torch.full((4,), 2.0, dtype=torch.bfloat16)])
    got = comm.exchange(x, [])
    assert isinstance(got, tuple) and isinstance(got[2], list)
    assert not got[0].any() and not bool(got[1]) and not got[2][0].any()
    assert got[2][0].dtype == torch.bfloat16


def test_distcomm_needs_a_matching_world(one_rank):
    mesh, _ = one_rank
    with pytest.raises(ValueError, match="n_ranks=2"):
        DistComm(2, "rows", mesh.group)


def test_distcomm_outside_a_world_raises():
    with pytest.raises(RuntimeError, match="rank world"):
        DistComm(1, "rows")


def test_coded_refuses_distcomm(one_rank):
    _, comm = one_rank
    x = np.ones((3, 2, 2), np.float32)
    with pytest.raises(ValueError) as want:
        jexecute_coded(jnp.asarray(x), JShardMapComm(3, "rows"), jmake_coded_plan(1, 2), "sum")
    with pytest.raises(ValueError) as got:
        execute_coded(torch.from_numpy(x), comm, make_coded_plan(1, 2), "sum")
    assert str(got.value) == str(want.value)


def test_mesh_programs_live_in_the_replay_cache(one_rank):
    """``ft_allreduce_jit(mesh=)`` traces once per key and signature, and
    ``replay.clear()`` drops its program as it drops the SimComm ones."""
    mesh, comm = one_rank
    x = torch.ones(1, 2, 3)

    def traces():
        t0 = dispatch.trace_count("ft_allreduce")
        ft_allreduce_jit(x, comm, mesh=mesh)
        return dispatch.trace_count("ft_allreduce") - t0

    replay.clear()
    assert [traces(), traces()] == [1, 0]
    replay.clear()
    assert traces() == 1


def test_mesh_program_evicted_past_its_bound_traces_again(one_rank):
    """``tsqr_shard_map`` (bound 64) under 65 statics keys, one ``reorth``
    each: the first key's eviction is counted and its next call traces."""
    mesh, _ = one_rank
    a = np.random.default_rng(0).standard_normal((6, 3)).astype(np.float32)
    replay.clear()
    ev0 = replay.stats()["evictions"]
    for k in range(1, 66):
        factorize(a, QRConfig(reorth=k), mesh=mesh)
    assert replay.stats()["evictions"] - ev0 == 1
    t0 = dispatch.trace_count("tsqr_shard_map")
    factorize(a, QRConfig(reorth=65), mesh=mesh)
    assert dispatch.trace_count("tsqr_shard_map") == t0
    factorize(a, QRConfig(reorth=1), mesh=mesh)
    assert dispatch.trace_count("tsqr_shard_map") == t0 + 1


def test_run_ranks_fails_with_the_rank_traceback(tmp_path):
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 failed.*boom on rank 1"):
        dist.run_ranks(dp.fail_on_rank, 2, device="cpu", args=(1,), rendezvous_dir=tmp_path)
    assert dist.run_ranks(dp.fail_on_rank, 2, device="cpu", args=(5,),
                          rendezvous_dir=tmp_path) == [0, 1]


def test_run_ranks_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dist.run_ranks(dp.fail_on_rank, 2, args=(5,))
