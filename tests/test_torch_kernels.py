"""The port's kernel layer against the JAX package's on the same inputs.

On the CPU each wrapper takes its kernel's plain PyTorch version, so these
hold the plain versions (and the ``ops`` pipeline around them) against the
Pallas kernels run in interpret mode, as tests/test_kernels.py runs them.
The Hopper kernels themselves are held against the same plain versions on
the card by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import traffic as jtraffic  # noqa: E402

from repro_torch.kernels import _build, _launch, dispatch, ops, traffic  # noqa: E402
from repro_torch.kernels.apply_right import apply_right  # noqa: E402
from repro_torch.kernels.fused_apply_gram import fused_apply_gram  # noqa: E402
from repro_torch.kernels.gram import gram  # noqa: E402

SHAPES = [(64, 4), (57, 7), (3, 16, 5), (2, 2, 40, 16)]
DTYPES = ["float32", "bfloat16"]


def _tol(dt):
    # tests/test_kernels.py's tolerances: the sums run in another order
    if dt == "bfloat16":
        return dict(rtol=3e-2, atol=3e-2)
    return dict(rtol=5e-4, atol=5e-4)


def _pair(x, dt):
    """The same values as a JAX array and a torch tensor of dtype ``dt``
    (both round float32 to bfloat16 to nearest even)."""
    return jnp.asarray(x, dtype=getattr(jnp, dt)), torch.from_numpy(x).to(getattr(torch, dt))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_gram_matches_pallas(rng, shape, dt):
    ja, ta = _pair(rng.standard_normal(shape).astype(np.float32), dt)
    want = jops.gram(ja, use_pallas=True, interpret=True)
    for got in (ops.gram(ta, use_pallas=True), ops.gram(ta), gram(ta)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("k_delta", [0, 3])
def test_apply_right_matches_pallas(rng, shape, dt, k_delta):
    n = shape[-1]
    w = rng.standard_normal(shape[:-2] + (n, n + k_delta)).astype(np.float32)
    ja, ta = _pair(rng.standard_normal(shape).astype(np.float32), dt)
    jw, tw = _pair(w, dt)
    want = jops.apply_right(ja, jw, use_pallas=True, interpret=True)
    for got in (ops.apply_right(ta, tw, use_pallas=True), apply_right(ta, tw)):
        assert got.dtype == ta.dtype and got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_fused_apply_gram_matches_pallas(rng, shape, dt):
    n = shape[-1]
    ja, ta = _pair(rng.standard_normal(shape).astype(np.float32), dt)
    jw, tw = _pair((rng.standard_normal(shape[:-2] + (n, n)) / np.sqrt(n)).astype(np.float32), dt)
    jq, jg = jops.fused_apply_gram(ja, jw, use_pallas=True, interpret=True)
    q, g = ops.fused_apply_gram(ta, tw, use_pallas=True)
    np.testing.assert_allclose(_np(q), _np(jq), **_tol(dt))
    gt = dict(rtol=5e-2, atol=5e-1) if dt == "bfloat16" else _tol(dt)
    np.testing.assert_allclose(_np(g), _np(jg), **gt)
    # within the port: want_q=False gives the same Gram, and the fused Gram
    # is the unfused gram(apply_right(A, W)) bit for bit
    assert torch.equal(fused_apply_gram(ta, tw, want_q=False), g)
    assert torch.equal(gram(apply_right(ta, tw)), g)


@pytest.mark.parametrize("fn", ["cholesky_qr2_r", "cholesky_qr2", "cholesky_qr2_unfused"])
def test_cqr2_traffic_records_equal_reference(rng, fn):
    """Same ops, sweeps and bytes per call as the reference (the port has no
    jit, so its ``traces`` field is always 0)."""
    x = rng.standard_normal((4, 96, 12)).astype(np.float32)
    kw = dict(fused=False) if fn.endswith("unfused") else {}
    name = fn.removesuffix("_unfused")
    with jtraffic.track_traffic() as jt:
        getattr(jops, name)(jnp.asarray(x), use_pallas=True, interpret=True, **kw)
    with traffic.track_traffic() as tt:
        getattr(ops, name)(torch.from_numpy(x), use_pallas=True, **kw)
    strip = [{k: v for k, v in r.items() if k != "traces"} for r in jt.records]
    assert [{k: v for k, v in r.items() if k != "traces"} for r in tt.records] == strip
    assert tt.tall_sweeps == {"cholesky_qr2_r": 2, "cholesky_qr2": 3,
                              "cholesky_qr2_unfused": 4}[fn]
    assert tt.read_bytes == jt.read_bytes and tt.write_bytes == jt.write_bytes


@pytest.mark.parametrize("use_pallas", [False, True])
def test_cholesky_qr2_matches_reference(rng, use_pallas):
    x = rng.standard_normal((3, 80, 10)).astype(np.float32)
    jq, jr = jops.cholesky_qr2(jnp.asarray(x), use_pallas=use_pallas, interpret=True)
    q, r = ops.cholesky_qr2(torch.from_numpy(x), use_pallas=use_pallas)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=5e-4, atol=5e-4)
    assert torch.equal(ops.cholesky_qr2_r(torch.from_numpy(x), use_pallas=use_pallas), r)
    qu, ru = ops.cholesky_qr2(torch.from_numpy(x), use_pallas=use_pallas, fused=False)
    np.testing.assert_allclose(ru.numpy(), r.numpy(), rtol=1e-5, atol=1e-5)
    eye = np.eye(10)
    for qq in (q, qu):
        qt = qq.numpy().astype(np.float64)
        assert np.abs(np.einsum("pmi,pmj->pij", qt, qt) - eye).max() < 3e-5


def test_non_pd_cholesky_is_nan_like_reference():
    g = np.array([[[4.0, 2.0], [2.0, 1.0]], [[4.0, 2.0], [2.0, -3.0]],
                  [[2.0, 0.0], [0.0, 3.0]], [[-1.0, 0.0], [0.0, 1.0]]], np.float32)
    want = np.asarray(jops._chol_upper(jnp.asarray(g)))
    got = ops._chol_upper(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert np.isnan(got[1]).any() and not np.isnan(got[2]).any()
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    poisoned = np.full((2, 6, 3), np.nan, np.float32)
    assert np.isnan(ops.cholesky_qr2_r(torch.from_numpy(poisoned)).numpy()).all()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(rng):
    a = torch.from_numpy(rng.standard_normal((2, 40, 8)).astype(np.float32))
    before = dispatch.launches.as_dict()
    ops.cholesky_qr2(a, use_pallas=True)
    assert dispatch.launches.as_dict() == before
    dispatch.launches.gram += 3
    dispatch.launches.reset()
    assert dispatch.launches.as_dict() == {"gram": 0, "fused_apply_gram": 0, "apply_right": 0,
                                           "trailing_update": 0, "panel_cross": 0,
                                           "pad_cross": 0, "combine_gram": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(8, 600)
    with pytest.raises(ValueError, match="512"):
        gram(a)
    with pytest.raises(TypeError, match="dtype"):
        gram(torch.zeros(8, 4, dtype=torch.float64))
    with pytest.raises(TypeError, match="must match"):
        apply_right(torch.zeros(8, 4), torch.zeros(4, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=r"\(\.\.\., 4, k\)"):
        fused_apply_gram(torch.zeros(8, 4), torch.zeros(5, 4))
    with pytest.raises(ValueError, match="contiguous"):
        gram(torch.zeros(4, 8).T)
    with pytest.raises(ValueError, match="meta"):
        gram(torch.zeros(8, 4, device="meta"))


@pytest.mark.parametrize("batch,m,width", [(1, 1, 1), (8, 131072, 32), (8, 524288, 128),
                                            (3, 1000, 256), (2, 33, 512)])
def test_row_split_covers_every_row_once(batch, m, width):
    rows, splits = _launch.row_split(batch, m, width)
    assert rows % 32 == 0 and rows * (splits - 1) < m <= rows * splits
    assert 1 <= splits <= 65535


# The Gram kernels' split at the main paths' shapes.  gram's partials and
# fused_apply_gram's G' are summed over these rows in order, so every R bit
# of the TSQR paths (and G' == gram(apply_right)) rests on them: a change
# must be deliberate, never a side effect of a kernel's redesign.
@pytest.mark.parametrize("batch,m,width,want", [
    (8, 1 << 19, 128, (7968, 66)), (8, 1 << 17, 128, (2016, 66)), (8, 1 << 17, 32, (2016, 66)),
    (8, 1 << 17, 512, (18752, 7)), (1, 1000, 96, (32, 32)),
])
def test_row_split_is_pinned_at_the_main_path_shapes(batch, m, width, want):
    assert _launch.row_split(batch, m, width) == want


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "out")
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build_all()
    assert _build.source_key() == _build.source_key()
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(_build.KERNELS)
