"""Shared helpers of the blocked-QR parity tests: run the port's and the
JAX package's ``factorize`` on the same blocks and compare R, Q, validity,
NaN poisoning and every ``PanelReport`` field."""
import dataclasses

import numpy as np

import jax_reference  # noqa: F401  (before any repro import)
import jax.numpy as jnp
from repro.qr import PanelFaultSchedule as JSchedule
from repro.qr import QRConfig as JQRConfig
from repro.qr import factorize as jfactorize

from repro_torch.core import ref
from repro_torch.qr import PanelFaultSchedule, QRConfig, factorize, panel_widths

VARIANTS = ("tree", "redundant", "replace", "selfhealing")
SHAPES = [(4, 32, 12, 4), (8, 24, 17, 5)]      # (P, m_local, n, panel_width)
TOL = dict(rtol=5e-4, atol=5e-4)


def blocks_of(rng, p, m_local, n):
    return rng.standard_normal((p, m_local, n)).astype(np.float32)


def dense_r(blocks):
    return ref.qr_r(blocks.reshape(-1, blocks.shape[-1]).astype(np.float64))


def _assert_plan_equal(got, want):
    if want is None:
        assert got is None
        return
    assert (got.variant, got.n_ranks, got.n_steps) == (want.variant, want.n_ranks, want.n_steps)
    np.testing.assert_array_equal(got.death, want.death)
    np.testing.assert_array_equal(got.final_valid, want.final_valid)
    assert len(got.steps) == len(want.steps)
    for gs, ws in zip(got.steps, want.steps):
        assert (gs.level, gs.perm_rounds, gs.restore_rounds) == (
            ws.level, ws.perm_rounds, ws.restore_rounds)
        np.testing.assert_array_equal(gs.valid_after, ws.valid_after)
        np.testing.assert_array_equal(gs.respawned, ws.respawned)


def _assert_nan_close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    np.testing.assert_allclose(got[finite], want[finite], **TOL)


def assert_same(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    _assert_nan_close(got.r, want.r)
    assert (got.q is None) == (want.q is None)
    if want.q is not None:
        _assert_nan_close(got.q, want.q)
    assert got.panel_width == want.panel_width and got.n_panels == want.n_panels
    assert got.recoverable == want.recoverable and got.detected is None
    for g, w in zip(got.reports, want.reports):
        for field in dataclasses.fields(g):
            if field.name in ("plan_r", "plan_w"):
                _assert_plan_equal(getattr(g, field.name), getattr(w, field.name))
            else:
                assert getattr(g, field.name) == getattr(w, field.name), field.name
        assert g.within_tolerance == w.within_tolerance


def schedules(faults):
    if faults is None:
        return None, None
    return PanelFaultSchedule.of(**faults), JSchedule.of(**faults)


def both(blocks, faults=None, **cfg):
    tf, jf = schedules(faults)
    got = factorize(blocks, QRConfig(**cfg), faults=tf, device="cpu")
    want = jfactorize(jnp.asarray(blocks), JQRConfig(**cfg), faults=jf)
    assert_same(got, want)
    return got, want


def check_fault_free(rng, variant, shape):
    """One fault-free factorization against the reference and the float64
    truth: validity, the replicated R on every rank, Q's orthonormality."""
    p, m, n, pw = shape
    blocks = blocks_of(rng, p, m, n)
    got, _ = both(blocks, panel_width=pw, variant=variant, compute_q=variant != "tree")
    assert got.n_panels == len(panel_widths(n, pw))
    expect = (np.arange(p) == 0) if variant == "tree" else np.ones(p, bool)
    np.testing.assert_array_equal(got.valid.numpy(), expect)
    truth = dense_r(blocks)
    for r in got.r.numpy():          # every rank holds the replicated R
        np.testing.assert_allclose(r, truth, **TOL)
        assert not np.tril(r, -1).any()
    if got.q is not None:
        q = got.q.numpy().reshape(-1, n).astype(np.float64)
        assert np.abs(q.T @ q - np.eye(n)).max() < 5e-5
        np.testing.assert_allclose(q @ got.r.numpy()[0], blocks.reshape(-1, n), **TOL)
