"""The port's legacy kwarg entry points (``tsqr_sim``, ``blocked_qr_sim``,
``blocked_qr_batched``) and its ``core`` facade, on the CPU.

Each shim warns ``DeprecationWarning`` naming the port's ``QRConfig`` and
``factorize``; returns R, Q and the validity bits bit for bit equal to
``factorize`` with the equal ``QRConfig`` (port against port); and is within
``R_TOL`` of max|R| of the reference's shim on the same numpy input, the
validity bits exact.  ``repro_torch.core.__all__`` and
``repro_torch.qr.__all__`` hold every name of the reference's, its mesh
shims and ``ShardMapComm`` included (the mesh routes themselves are held in
``test_torch_dist_qr.py``).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.core.tsqr as jcore_tsqr  # noqa: E402
from repro import qr as jqr  # noqa: E402
from repro.collective import FaultSpec as JFaultSpec  # noqa: E402

import repro_torch.core as core  # noqa: E402
import repro_torch.core.tsqr as core_tsqr  # noqa: E402
from repro_torch import qr  # noqa: E402
from repro_torch.collective import FaultSpec  # noqa: E402
from repro_torch.qr import QRConfig, factorize  # noqa: E402

# R of the two packages relative to max|R|: both factor f32 blocks on the CPU
# in their own summation orders (~1e-6 read at these sizes)
R_TOL = 1e-5
# names of the reference's facade that run the ranks as separate devices
# (in the port: separate processes)
MESH_NAMES = {"ShardMapComm", "tsqr_gram_shard_map", "tsqr_shard_map"}

P, M, N = 4, 48, 20


def _blocks(seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = (P, M, N) if batch is None else (batch, P, M, N)
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    if x is None:
        return None
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bitwise(got, want):
    """Bit for bit, NaN poisoning included."""
    assert (got is None) == (want is None)
    if got is not None:
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want)


def _close(got, want):
    """Within ``R_TOL`` of max|want|, NaN poisoning in the same places."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    if finite.any():
        err = float(np.abs(got[finite] - want[finite]).max())
        assert err <= R_TOL * float(np.abs(want[finite]).max())


def _call(fn, *args, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    deprecations = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    return out, deprecations


# ---------------------------------------------------------------------------
# tsqr_sim
# ---------------------------------------------------------------------------

TSQR_CASES = [
    dict(),
    dict(variant="tree"),
    dict(variant="replace", deaths={1: 2}),
    dict(variant="selfhealing", deaths={0: 1}, compute_q=True),
    dict(local_qr="cqr2", compute_q=True, reorth=2),
]


@pytest.mark.parametrize("case", TSQR_CASES,
                         ids=lambda c: "-".join(map(str, c.items())) or "default")
def test_tsqr_sim_warns_and_equals_factorize_and_reference(case):
    case = dict(case)
    deaths = case.pop("deaths", None)
    a = _blocks(1)
    got, warned = _call(qr.tsqr_sim, a, fault_spec=FaultSpec.of(deaths) if deaths else None,
                        device="cpu", **case)
    assert len(warned) == 1
    msg = str(warned[0].message)
    assert msg.startswith("tsqr_sim() is deprecated")
    assert "repro_torch.qr.api.QRConfig" in msg and "repro_torch.qr.api.factorize" in msg
    assert warned[0].filename == __file__

    cfg = QRConfig(panel_width=None, variant=case.get("variant", "redundant"),
                   local_r=case.get("local_qr", "jnp"), reorth=case.get("reorth", 1),
                   compute_q=case.get("compute_q", False))
    want = factorize(a, cfg, faults=FaultSpec.of(deaths) if deaths else None, device="cpu")
    _bitwise(got.r, want.r)
    _bitwise(got.valid, want.valid)
    _bitwise(got.q, want.q)

    ref, jwarned = _call(jqr.tsqr_sim, jnp.asarray(a),
                         fault_spec=JFaultSpec.of(deaths) if deaths else None, **case)
    assert len(jwarned) == 1
    np.testing.assert_array_equal(_np(got.valid), np.asarray(ref.valid))
    valid = _np(got.valid)
    _close(_np(got.r)[valid], np.asarray(ref.r)[valid])
    if case.get("compute_q"):
        _close(_np(got.q), np.asarray(ref.q))


# ---------------------------------------------------------------------------
# blocked_qr_sim
# ---------------------------------------------------------------------------

BLOCKED_CASES = [
    dict(panel_width=8),
    dict(panel_width=8, compute_q=True, pipeline="off"),
    dict(panel_width=8, pipeline="on", fuse="off"),
    dict(panel_width=6, compute_q=True, use_pallas=True),
    dict(panel_width=8, interpret=True),
    dict(panel_width=8, variant="replace", panel_deaths={1: {1: 2}}),
    dict(panel_width=8, recover="off", panel_deaths={0: {0: 1}}),
]


def _schedule(mod, spec_cls, deaths):
    if not deaths:
        return None
    return mod.PanelFaultSchedule.of(panel={k: spec_cls.of(v) for k, v in deaths.items()})


@pytest.mark.parametrize("case", BLOCKED_CASES,
                         ids=lambda c: "-".join(map(str, c.items())))
def test_blocked_qr_sim_warns_and_equals_factorize_and_reference(case):
    case = dict(case)
    deaths = case.pop("panel_deaths", None)
    a = _blocks(2)
    got, warned = _call(qr.blocked_qr_sim, a, faults=_schedule(qr, FaultSpec, deaths),
                        device="cpu", **case)
    assert len(warned) == 1 and str(warned[0].message).startswith("blocked_qr_sim()")
    assert warned[0].filename == __file__

    cfg = QRConfig(**{**dict(local_r="chol"), **case})
    want = factorize(a, cfg, faults=_schedule(qr, FaultSpec, deaths), device="cpu")
    _bitwise(got.r, want.r)
    _bitwise(got.valid, want.valid)
    _bitwise(got.q, want.q)
    assert got.n_panels == want.n_panels

    ref, jwarned = _call(jqr.blocked_qr_sim, jnp.asarray(a),
                         faults=_schedule(jqr, JFaultSpec, deaths), **case)
    assert len(jwarned) == 1
    np.testing.assert_array_equal(_np(got.valid), np.asarray(ref.valid))
    valid = _np(got.valid)
    _close(_np(got.r)[valid], np.asarray(ref.r)[valid])
    if case.get("compute_q"):
        _close(_np(got.q), np.asarray(ref.q))


def test_blocked_qr_sim_validates_interpret_as_the_config_does():
    with pytest.raises(ValueError, match="panel_width"):
        _call(qr.blocked_qr_sim, _blocks(), panel_width=0, device="cpu")
    with pytest.raises(ValueError, match="pipeline"):
        _call(qr.blocked_qr_sim, _blocks(), panel_width=8, pipeline="sometimes",
              device="cpu")


# ---------------------------------------------------------------------------
# blocked_qr_batched
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [dict(panel_width=8), dict(panel_width=8, compute_q=True),
                                  dict(panel_width=6, fuse="off", use_pallas=True)],
                         ids=lambda c: "-".join(map(str, c.items())))
def test_blocked_qr_batched_warns_and_equals_factorize_and_reference(case):
    a = _blocks(3, batch=2)
    got, warned = _call(qr.blocked_qr_batched, a, device="cpu", **case)
    assert len(warned) == 1 and str(warned[0].message).startswith("blocked_qr_batched()")
    assert warned[0].filename == __file__

    want = factorize(a, QRConfig(**{**dict(local_r="chol"), **case}), device="cpu")
    _bitwise(got.r, want.r)
    _bitwise(got.valid, want.valid)
    _bitwise(got.q, want.q)

    ref, jwarned = _call(jqr.blocked_qr_batched, jnp.asarray(a), **case)
    assert len(jwarned) == 1
    np.testing.assert_array_equal(_np(got.valid), np.asarray(ref.valid))
    _close(got.r, np.asarray(ref.r))
    if case.get("compute_q"):
        _close(got.q, np.asarray(ref.q))


def test_blocked_qr_batched_refuses_a_pipeline_ineligible_variant():
    with pytest.raises(ValueError, match="not pipeline-eligible"):
        _call(qr.blocked_qr_batched, _blocks(batch=2), panel_width=8, variant="tree",
              device="cpu")


# ---------------------------------------------------------------------------
# the packages' exports and the core facade
# ---------------------------------------------------------------------------

def test_qr_exports_the_shims_the_reference_has_but_its_mesh_shims():
    # the name stays; the mesh shims are exported now too
    assert set(jqr.__all__) <= set(qr.__all__)
    assert {"tsqr_sim", "blocked_qr_sim", "blocked_qr_batched", "blocked_qr_shard_map",
            "tsqr_gram_shard_map", "tsqr_shard_map"} <= set(qr.__all__)
    assert set(qr.__all__) - set(jqr.__all__) == {"Redundancy"}


def test_core_all_is_the_reference_less_the_mesh_names():
    # the name stays; the mesh names are exported now too
    assert set(core.__all__) == set(jcore.__all__)
    assert set(jcore.__all__) & MESH_NAMES == MESH_NAMES
    for name in core.__all__:
        assert getattr(core, name) is not None, name
    assert core.tsqr_sim is qr.tsqr_sim and core.TSQRResult is qr.TSQRResult
    assert core.form_q is qr.form_q
    assert core.tsqr_shard_map is qr.tsqr_shard_map
    assert core.tsqr_gram_shard_map is qr.tsqr_gram_shard_map


def test_core_tsqr_facade_names():
    assert set(core_tsqr.__all__) == set(jcore_tsqr.__all__)
    assert set(core_tsqr.local_qr_fns) == set(jcore_tsqr.local_qr_fns)
    for name in ("qr_r_jnp", "qr_r_cqr2", "qr_r_cqr2_pallas", "_resolve_local_qr"):
        assert callable(getattr(core_tsqr, name)), name
    assert core_tsqr.qr_r_jnp is core_tsqr.local_qr_fns["jnp"]


def test_core_tsqr_sim_factors_like_the_reference():
    a = _blocks(4)
    got, _ = _call(core.tsqr_sim, a, device="cpu")
    ref, _ = _call(jcore.tsqr_sim, jnp.asarray(a))
    np.testing.assert_array_equal(_np(got.valid), np.asarray(ref.valid))
    _close(got.r, np.asarray(ref.r))
