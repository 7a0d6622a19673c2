"""``factorize`` with ``redundancy="coded"`` against the JAX package's on the
same row blocks, on both 3-D routes: TSQR (``panel_width=None``, with
``observed=`` silent corruption and ``compute_q``) and the blocked QR (the
eager driver, fused and split schedules).  Plans, validity, ``detected``,
every ``PanelReport`` field and the traffic records equal the reference's;
R agrees within 5e-5 of max|R| fault-free and within
``reconstruction_tol`` when faulted.  Within the port, fault-free coded R
equals the butterfly's bit for bit, as it does in the reference (checked
there for the blocked QR's eager driver as well)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from coded_parity import assert_plans_equal, spec  # noqa: E402
from repro.collective import FaultSpec as JFaultSpec  # noqa: E402
from repro.kernels import traffic as jtraffic  # noqa: E402
from repro.qr import PanelFaultSchedule as JSchedule  # noqa: E402
from repro.qr import QRConfig as JQRConfig  # noqa: E402
from repro.qr import factorize as jfactorize  # noqa: E402
from repro.qr import tsqr as jtsqr  # noqa: E402

from repro_torch.collective import FaultSpec, reconstruction_tol  # noqa: E402
from repro_torch.core import ref  # noqa: E402
from repro_torch.kernels import traffic  # noqa: E402
from repro_torch.qr import PanelFaultSchedule, QRConfig, factorize  # noqa: E402
from repro_torch.qr import tsqr as ttsqr  # noqa: E402

P, M, N = 8, 32, 6
R_TOL = 5e-5
F32_RECON = reconstruction_tol(torch.float32)

# (deaths, slow, corrupt) in world coordinates; the corrupt rank's observed
# block is tripled.  c = 3 throughout.
TSQR_FAULTS = {
    "none": ((), (), ()),
    "root_and_two_dead": ((0, 2, 4), (), ()),
    "stragglers": ((), (2, 5), ()),
    "sdc": ((), (), (6,)),
    "mixed_with_parity_death": ((1, 9), (4,), ()),
    "over_budget": ((0, 1, 2, 3), (), ()),
}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(1.0, np.abs(want).max())


def _assert_r_close(got_r, want_r, valid, faulted):
    got_r, want_r = got_r.numpy(), np.asarray(want_r)
    np.testing.assert_array_equal(np.isnan(got_r), np.isnan(want_r))
    rows = np.asarray(valid)
    if rows.any():
        assert _rel(got_r[rows], want_r[rows]) <= (F32_RECON if faulted else R_TOL)


@pytest.mark.parametrize("fault", sorted(TSQR_FAULTS))
@pytest.mark.parametrize("local_r", ["jnp", "cqr2", "cqr2_pallas"])
def test_coded_tsqr_matches_reference(rng, local_r, fault):
    deaths, slow, corrupt = TSQR_FAULTS[fault]
    blocks = rng.standard_normal((P, M, N)).astype(np.float32)
    observed = blocks.copy()
    observed[list(corrupt)] *= 3.0
    obs = observed if corrupt else None
    cfg = dict(local_r=local_r, redundancy="coded", parity=3)
    want = jtsqr._factorize_sim(jnp.asarray(blocks), JQRConfig(**cfg),
                                fault_spec=spec(JFaultSpec, deaths, slow, corrupt),
                                observed=None if obs is None else jnp.asarray(obs))
    got = ttsqr._factorize_sim(torch.from_numpy(blocks), QRConfig(**cfg),
                               fault_spec=spec(FaultSpec, deaths, slow, corrupt), observed=obs)
    assert_plans_equal(got.plan, want.plan)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.detected.numpy(), np.asarray(want.detected))
    assert np.flatnonzero(got.detected.numpy()).tolist() == list(corrupt)
    _assert_r_close(got.r, want.r, want.valid, fault != "none")
    if got.plan.recoverable:
        truth = ref.qr_r(blocks.reshape(-1, N).astype(np.float64))
        assert _rel(got.r.numpy()[0], truth) <= (F32_RECON if fault != "none" else R_TOL)
    else:
        assert not got.valid.any() and bool(torch.isnan(got.r).all())


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("local_r", ["jnp", "cqr2", "cqr2_pallas"])
def test_fault_free_coded_tsqr_bitwise_equals_butterfly(rng, local_r, c):
    blocks = rng.standard_normal((P, M, N)).astype(np.float32)
    coded = factorize(blocks, QRConfig(local_r=local_r, redundancy="coded", parity=c),
                      device="cpu")
    fly = factorize(blocks, QRConfig(local_r=local_r), device="cpu")
    assert torch.equal(coded.r, fly.r) and bool(coded.valid.all())
    assert not bool(coded.detected.any()) and coded.plan.is_fault_free


@pytest.mark.parametrize("deaths", [(), (0, 5)])
def test_coded_tsqr_compute_q_matches_reference(rng, deaths):
    blocks = rng.standard_normal((P, M, N)).astype(np.float32)
    cfg = dict(local_r="cqr2_pallas", redundancy="coded", parity=2, compute_q=True)
    want = jfactorize(jnp.asarray(blocks), JQRConfig(**cfg),
                      faults=JFaultSpec.of({r: 0 for r in deaths}))
    got = factorize(blocks, QRConfig(**cfg), faults=FaultSpec.of({r: 0 for r in deaths}),
                    device="cpu")
    tol = F32_RECON if deaths else R_TOL
    assert _rel(got.q.numpy(), want.q) <= tol and _rel(got.r.numpy(), want.r) <= tol
    q = got.q.numpy().reshape(-1, N).astype(np.float64)
    assert np.abs(q.T @ q - np.eye(N)).max() < 5e-5


def test_coded_tsqr_refusals_match_reference(rng):
    blocks = rng.standard_normal((4, 16, 3)).astype(np.float32)
    over = dict(deaths=((0, 0), (1, 0), (2, 0)))
    cfg = dict(redundancy="coded", parity=2, compute_q=True)
    with pytest.raises(ValueError) as want:
        jfactorize(jnp.asarray(blocks), JQRConfig(**cfg), faults=JFaultSpec(**over))
    with pytest.raises(ValueError) as got:
        factorize(blocks, QRConfig(**cfg), faults=FaultSpec(**over), device="cpu")
    assert str(got.value) == str(want.value)
    # observed= only means something to the coded scheme
    with pytest.raises(ValueError) as want:
        jtsqr._factorize_sim(jnp.asarray(blocks), JQRConfig(), observed=jnp.asarray(blocks))
    with pytest.raises(ValueError) as got:
        ttsqr._factorize_sim(torch.from_numpy(blocks), QRConfig(), observed=blocks)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The blocked QR
# ---------------------------------------------------------------------------

BLOCKED = (8, 32, 15, 4)           # (P, m_local, n, panel_width): 4 panels, ragged

BLOCKED_FAULTS = {
    "none": None,
    "panel_two_dead": dict(panel={1: {3: 0, 6: 0}}),
    "update_death": dict(update={0: {5: 1}}),
    "declared_corrupt": dict(panel={0: FaultSpec.of({}, corrupt=(2,))}),
    "straggler_each_phase": dict(panel={2: FaultSpec.of({}, slow=(7,))},
                                 update={1: {0: 0}}),
    "over_budget": dict(panel={1: {1: 0, 4: 0, 6: 0}}),
}


def _schedules(faults):
    if faults is None:
        return None, None

    def conv(d):
        return {k: (JFaultSpec(v.deaths, v.corrupt, v.slow) if isinstance(v, FaultSpec) else v)
                for k, v in d.items()}

    return (PanelFaultSchedule.of(**faults),
            JSchedule.of(**{k: conv(v) for k, v in faults.items()}))


def _strip(records):
    return [{k: v for k, v in r.items() if k not in ("dispatches", "traces")} for r in records]


def _assert_reports_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in dataclasses.fields(g):
            gv, wv = getattr(g, field.name), getattr(w, field.name)
            if field.name in ("plan_r", "plan_w"):
                assert (gv is None) == (wv is None)
                if wv is not None:
                    assert_plans_equal(gv, wv)
            else:
                assert gv == wv, field.name
        assert g.within_tolerance == w.within_tolerance


@pytest.mark.parametrize("fault", sorted(BLOCKED_FAULTS))
@pytest.mark.parametrize("fields", [dict(), dict(fuse="off"), dict(use_pallas=True),
                                    dict(local_r="cqr2", compute_q=True)], ids=str)
def test_coded_blocked_matches_reference(rng, fields, fault):
    p, m, n, pw = BLOCKED
    blocks = rng.standard_normal((p, m, n)).astype(np.float32)
    tf, jf = _schedules(BLOCKED_FAULTS[fault])
    over = fault == "over_budget"
    if over and fields.get("compute_q"):
        fields = dict(fields, compute_q=False)
    cfg = dict(panel_width=pw, redundancy="coded", parity=2, **fields)
    with jtraffic.track_traffic() as jt:
        want = jfactorize(jnp.asarray(blocks), JQRConfig(**cfg), faults=jf)
    with traffic.track_traffic() as tt:
        got = factorize(blocks, QRConfig(**cfg), faults=tf, device="cpu")
    assert _strip(tt.records) == _strip(jt.records)
    _assert_reports_equal(got.reports, want.reports)
    assert all(rep.scheme == "coded" for rep in got.reports)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.detected.numpy(), np.asarray(want.detected))
    assert not bool(got.detected.any())      # a declared, unperturbed rank is not flagged
    faulted = BLOCKED_FAULTS[fault] is not None
    _assert_r_close(got.r, want.r, want.valid, faulted)
    if over:
        assert not bool(got.valid.any()) and not got.recoverable
        return
    assert bool(got.valid.all())             # dead data ranks are respawned
    truth = ref.qr_r(blocks.reshape(-1, n).astype(np.float64))
    for r in got.r.numpy():
        assert _rel(r, truth) <= (F32_RECON if faulted else 5e-4)
    if fields.get("compute_q"):
        assert _rel(got.q.numpy(), want.q) <= (F32_RECON if faulted else R_TOL)


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("fields", [dict(), dict(fuse="off"), dict(use_pallas=True)], ids=str)
def test_fault_free_coded_blocked_bitwise_equals_eager_butterfly(rng, fields, c):
    p, m, n, pw = BLOCKED
    blocks = rng.standard_normal((p, m, n)).astype(np.float32)
    coded = factorize(blocks, QRConfig(panel_width=pw, redundancy="coded", parity=c, **fields),
                      device="cpu")
    eager = factorize(blocks, QRConfig(panel_width=pw, pipeline="off", **fields), device="cpu")
    assert torch.equal(coded.r, eager.r) and torch.equal(coded.valid, eager.valid)
