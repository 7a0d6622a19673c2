"""The mesh routes of the port's QR layer against the reference's, on the
cases of the reference's own SPMD tests (``tests/test_spmd.py:29`` TSQR,
``:67`` the blocked QR) and the Gram-butterfly TSQR.

The port's side runs in one world of 8 CPU ranks over gloo, each rank
passing its own (m_local, n) block; the reference's in a subprocess with
8 forced host devices on the global matrix; both once per test session,
shared with ``test_torch_dist.py`` (``dist_parity.both_sides``).  Concatenated in rank order, the port's
per-rank outputs are held against the reference's: validity, plans,
reports, NaN poisoning and the ``track_dispatch`` and ``track_traffic``
dicts of the first and the warm call (``kernel:<op>`` keys included)
exactly, values within ``TOL``.  Within the port, every rank's result is
held against SimComm's on the same stack within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from repro.qr import QRConfig as JQRConfig  # noqa: E402
from repro.qr import factorize as jfactorize  # noqa: E402

import dist_parity as dp  # noqa: E402
from repro_torch.collective import FaultSpec, make_plan  # noqa: E402
from repro_torch.collective.dist import RankMesh  # noqa: E402
from repro_torch.core import ref  # noqa: E402
from repro_torch.qr import QRConfig, factorize  # noqa: E402

TOL = dict(rtol=5e-4, atol=5e-4)
SIM = dict(rtol=1e-5, atol=1e-5)
TSQR_CASES = [(v, None) for v in dp.VARIANTS] + [
    (v, d) for d in dp.QR_SPECS for v in dp.FAULTED]


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return dp.both_sides(tmp_path_factory, "qr")


@pytest.fixture(scope="module")
def inputs():
    return dp.qr_inputs(ref)


def _stack(port, key, i=0):
    return dp.gather(port, lambda o: o[key][i])


@pytest.mark.parametrize("variant,deaths", TSQR_CASES,
                         ids=[f"{v}-{dp._key(d)}" for v, d in TSQR_CASES])
def test_tsqr_matches_reference(sides, inputs, variant, deaths):
    port, want = sides
    key = ("tsqr", variant, dp._key(deaths))
    r, valid = _stack(port, key, 0), _stack(port, key, 1)
    wr, wvalid, final_valid, messages = want[key]
    plan = make_plan(variant, dp.P, FaultSpec.of(deaths) if deaths else None)
    np.testing.assert_array_equal(valid, wvalid)
    np.testing.assert_array_equal(valid, plan.final_valid)
    for out in port:
        np.testing.assert_array_equal(out[key][2], final_valid)
        assert out[key][3] == messages == plan.message_count()
    np.testing.assert_array_equal(np.isnan(r), np.isnan(wr))
    truth = ref.qr_r(inputs["tsqr"].reshape(-1, 4).astype(np.float64))
    for i in np.flatnonzero(valid):
        np.testing.assert_allclose(r[i], wr[i], **TOL)
        np.testing.assert_allclose(r[i], truth, rtol=7e-4, atol=7e-4)


def test_tsqr_against_simcomm(sides):
    port, _ = sides
    for i, out in enumerate(port):
        np.testing.assert_allclose(out[("tsqr", "redundant", "none")][0][0], out["sim"]["tsqr"],
                                   **SIM)
        np.testing.assert_allclose(out["tsqr_q"][1], out["sim"]["tsqr_q"], **SIM)
        for deaths in dp.QR_SPECS:
            row = out[("tsqr", "replace", dp._key(deaths))]
            if row[1][0]:
                np.testing.assert_allclose(row[0][0], out["sim"][("tsqr_replace",
                                                                  dp._key(deaths))], **SIM)


def test_tsqr_q_matches_reference(sides, inputs):
    port, want = sides
    q = _stack(port, "tsqr_q", 1)
    np.testing.assert_allclose(q, want["tsqr_q"][1], **TOL)
    np.testing.assert_allclose(_stack(port, "tsqr_q", 0), want["tsqr_q"][0], **TOL)
    np.testing.assert_allclose(q.T @ q, np.eye(4), atol=2e-5)


@pytest.mark.parametrize("call", ["tsqr_first", "tsqr_warm"])
def test_tsqr_counts_match_reference(sides, call):
    port, want = sides
    for out in port:
        assert out[call] == want[call]
    traces = port[0][call][0]["traces"]
    assert traces == ({"tsqr_shard_map": 1} if call == "tsqr_first" else {})


def test_tsqr_kernel_route_matches_reference(sides):
    """``local_r="cqr2_pallas"`` on the mesh: the kernels' calls on a
    rank's 2-D block count the reference's ``kernel:<op>`` traces and
    dispatches."""
    port, want = sides
    wr, wq, wd, wt = want["tsqr_kernels"]
    np.testing.assert_allclose(_stack(port, "tsqr_kernels", 0), wr, **TOL)
    np.testing.assert_allclose(_stack(port, "tsqr_kernels", 1), wq, **TOL)
    assert any(k.startswith("kernel:") for k in wd["traces"])
    for out in port:
        assert out["tsqr_kernels"][2:] == (wd, wt)


def test_gram_butterfly_matches_reference(sides, inputs):
    port, want = sides
    wr, wvalid, wq, wd, wt, wshim_r, wshim_q, wfinal = want["gram"]
    r, q = _stack(port, "gram", 0), _stack(port, "gram", 2)
    np.testing.assert_allclose(r, wr, **TOL)
    np.testing.assert_allclose(q, wq, **TOL)
    np.testing.assert_array_equal(_stack(port, "gram", 1), wvalid)
    assert wvalid.all()
    truth = ref.qr_r(inputs["wide"].reshape(-1, 6).astype(np.float64))
    for i in range(dp.P):
        np.testing.assert_allclose(r[i], truth, **TOL)
    np.testing.assert_allclose(q.T @ q, np.eye(6), atol=2e-5)
    for out in port:
        _, _, _, d, t, shim_r, shim_q, final = out["gram"]
        assert (d, t) == (wd, wt)
        assert d["traces"] == {"tsqr_gram_shard_map": 1}
        np.testing.assert_array_equal(final, wfinal)
        assert np.array_equal(shim_r, out["gram"][0]) and np.array_equal(shim_q, out["gram"][2])
        np.testing.assert_allclose(out["gram"][0][0], out["sim"]["gram"][0], **SIM)
        np.testing.assert_allclose(out["gram"][2], out["sim"]["gram"][1], **SIM)


def test_blocked_pipeline_matches_reference(sides, inputs):
    port, want = sides
    wr, wvalid, wq, wfirst, wwarm = want["blocked"]
    r, q = _stack(port, "blocked", 0), _stack(port, "blocked", 2)
    np.testing.assert_array_equal(_stack(port, "blocked", 1), wvalid)
    assert wvalid.all()
    np.testing.assert_allclose(r, wr, **TOL)
    np.testing.assert_allclose(q, wq, **TOL)
    a = inputs["blocked"].reshape(-1, 15)
    rt = ref.qr_r(a.astype(np.float64))
    for i in range(dp.P):
        np.testing.assert_allclose(r[i], rt, **TOL)
    np.testing.assert_allclose(q.T @ q, np.eye(15), atol=5e-5)
    np.testing.assert_allclose(q @ r[0], a, **TOL)
    for out in port:
        _, _, _, first, warm, same = out["blocked"]
        assert first == wfirst and warm == wwarm and same
        assert first[0]["traces"].get("blocked_qr_pipeline") == 1
        assert "blocked_qr_pipeline" not in warm[0]["traces"]
        np.testing.assert_allclose(out["blocked"][0][0], out["sim"]["blocked"][0], **SIM)
        np.testing.assert_allclose(out["blocked"][2], out["sim"]["blocked"][1], **SIM)


def test_blocked_faulted_matches_reference(sides, inputs):
    """A panel-phase death and an update-phase death under ``replace``:
    validity is the strict survivors, and the replica fetches over the
    wires restore R on every rank."""
    port, want = sides
    wr, wvalid, wfirst, wwarm, wreports = want["blocked_faulted"]
    valid = _stack(port, "blocked_faulted", 1)
    np.testing.assert_array_equal(valid, wvalid)
    assert not valid.all() and valid.any()
    r = _stack(port, "blocked_faulted", 0)
    rt = ref.qr_r(inputs["blocked"].reshape(-1, 15).astype(np.float64))
    for i in range(dp.P):
        np.testing.assert_allclose(r[i], wr[i], **TOL)
        np.testing.assert_allclose(r[i], rt, **TOL)
    for out in port:
        _, _, first, warm, reports = out["blocked_faulted"]
        assert reports == wreports
        assert first == wfirst and warm == wwarm
        assert first[0]["traces"]["blocked_qr_shard_map"] == 1 and not warm[0]["traces"]
        np.testing.assert_allclose(out["blocked_faulted"][0][0], out["sim"]["blocked_faulted"],
                                   **SIM)


def test_blocked_without_recovery_poisons_like_reference(sides):
    port, want = sides
    wr, wvalid, wreports = want["blocked_no_recovery"]
    r = _stack(port, "blocked_no_recovery", 0)
    np.testing.assert_array_equal(_stack(port, "blocked_no_recovery", 1), wvalid)
    np.testing.assert_array_equal(np.isnan(r), np.isnan(wr))
    assert np.isnan(r).any()
    for i in np.flatnonzero(wvalid):
        np.testing.assert_allclose(r[i], wr[i], **TOL)
    for out in port:
        assert out["blocked_no_recovery"][2] == wreports


# ---------------------------------------------------------------------------
# Routing and refusals (no world needed: they raise before any exchange)
# ---------------------------------------------------------------------------

def _mesh(*axes):
    return RankMesh(axes, (0,), torch.device("cpu"))


def test_mesh_route_needs_a_rank_block():
    blocks = np.zeros((2, 8, 2), np.float32)
    with pytest.raises(ValueError, match=r"cannot route input of shape \(2, 8, 2\) with "
                                         r"mesh=present"):
        factorize(blocks, QRConfig(), mesh=_mesh("rows"))


def test_mesh_axis_must_be_named_on_a_two_axis_mesh():
    a = np.zeros((8, 2), np.float32)
    with pytest.raises(ValueError, match=r"mesh has axes \('data', 'rows'\); pass axis="):
        factorize(a, QRConfig(), mesh=_mesh("data", "rows"))


def test_gram_without_a_mesh_raises_the_reference_error():
    blocks = np.zeros((2, 8, 2), np.float32)
    with pytest.raises(ValueError) as want:
        jfactorize(jnp.asarray(blocks), JQRConfig(gram=True))
    with pytest.raises(ValueError) as got:
        factorize(blocks, QRConfig(gram=True), device="cpu")
    assert str(got.value) == str(want.value)
