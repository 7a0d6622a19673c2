"""The port's blocked-QR sweeps (``trailing_update``, ``panel_cross``,
``pad_cross``) against the JAX package's on the same inputs.

On the CPU each kernel wrapper takes its plain PyTorch version, so these
hold the plain versions, and the ``ops`` layer and the row-split and stride
plumbing around them, against the reference's jnp oracles and its Pallas
kernels run in interpret mode.  The Hopper kernels themselves are held
against the same plain versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import traffic as jtraffic  # noqa: E402

from repro_torch.kernels import _launch, dispatch, ops, ref, traffic  # noqa: E402
from repro_torch.kernels import trailing_update as tmod  # noqa: E402

# (leading dims, m, b, n_t): a bare matrix, a P = 4 stack, a 4-D batch
SHAPES = [((), 40, 5, 12), ((4,), 33, 4, 9), ((2, 3), 24, 3, 7)]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
ROUTES = ["jnp", "pallas"]


def _close(got, want, dt):
    """max |got − want| / max |want| within the dtype's tolerance."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL[dt] * max(np.abs(want).max(), 1e-30)


def _pair(x, dt):
    return jnp.asarray(x, dtype=getattr(jnp, dt)), torch.from_numpy(x).to(getattr(torch, dt))


def _ref_kw(route):
    return dict(use_pallas=True, interpret=True) if route == "pallas" else {}


def _operands(rng, lead, m, b, nt, dt):
    a = rng.standard_normal(lead + (m, nt)).astype(np.float32)
    q = rng.standard_normal(lead + (m, b)).astype(np.float32)
    w = (rng.standard_normal(lead + (b, nt)) / np.sqrt(b)).astype(np.float32)
    return _pair(a, dt), _pair(q, dt), _pair(w, dt)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_trailing_update_matches_reference(rng, shape, dt, route):
    lead, m, b, nt = shape
    (ja, ta), (jq, tq), (jw, tw) = _operands(rng, lead, m, b, nt, dt)
    for next_width in (0, b):
        want = jops.trailing_update(ja, jq, jw, next_width=next_width, **_ref_kw(route))
        for use_pallas in (False, True):
            got = ops.trailing_update(ta, tq, tw, next_width=next_width, use_pallas=use_pallas)
            if next_width:
                assert got[0].dtype == ta.dtype and got[1].dtype == torch.float32
                _close(got[0], want[0], dt)
                _close(got[1], want[1], dt)
                # the lookahead S is panel_cross of the stored (cast) A_new
                assert torch.equal(got[1], ref.panel_cross(got[0], split=next_width))
            else:
                _close(got, want, dt)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_panel_cross_matches_reference(rng, shape, dt, route):
    lead, m, b, nt = shape
    ja, ta = _pair(rng.standard_normal(lead + (m, nt)).astype(np.float32), dt)
    for split in (1, b, nt):
        want = jops.panel_cross(ja, split=split, **_ref_kw(route))
        for use_pallas in (False, True):
            got = ops.panel_cross(ta, split=split, use_pallas=use_pallas)
            assert got.dtype == torch.float32
            _close(got, want, dt)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pad_cross_matches_reference(rng, shape, dt, route):
    lead, m, b, nt = shape
    ja, ta = _pair(rng.standard_normal(lead + (m, nt)).astype(np.float32), dt)
    out_width = nt + 5
    jpad, js = jops.pad_cross(ja, split=b, out_width=out_width, **_ref_kw(route))
    for use_pallas in (False, True):
        a_pad, s = ops.pad_cross(ta, split=b, out_width=out_width, use_pallas=use_pallas)
        assert a_pad.dtype == ta.dtype and tuple(a_pad.shape) == jpad.shape
        _close(a_pad, jpad, dt)
        _close(s, js, dt)
        # pad columns are exact zeros; the copy and S's real columns are exact
        assert not a_pad[..., nt:].any() and not s[..., nt:].any()
        assert torch.equal(a_pad[..., :nt], ta)
        assert torch.equal(s[..., :nt], ref.panel_cross(ta, split=b))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("extra", [0, 1, 5, 64])
def test_pad_cross_real_columns_do_not_depend_on_the_width(rng, dt, extra):
    """The plain pad_cross keeps the kernels' width contract by
    construction: S's real columns are panel_cross of A to the bit, and the
    pad columns exact zeros, whatever the padded width and the host BLAS."""
    _, ta = _pair(rng.standard_normal((3, 37, 11)).astype(np.float32), dt)
    a_pad, s = ref.pad_cross(ta, split=4, out_width=11 + extra)
    assert torch.equal(s[..., :11], ref.panel_cross(ta, split=4))
    assert not s[..., 11:].any() and not a_pad[..., 11:].any()
    assert torch.equal(a_pad[..., :11], ta)


def test_strided_views_take_no_copy_and_match_dense(rng):
    """The drivers pass the trailing block as a column slice; the wrappers
    take it as it is and give the same values as a dense copy."""
    wide = torch.from_numpy(rng.standard_normal((4, 30, 11)).astype(np.float32))
    trail = wide[..., :, 3:]
    q = torch.from_numpy(rng.standard_normal((4, 30, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 3, 8)).astype(np.float32))
    out_buf = torch.zeros(4, 30, 12)
    a_new, s = tmod.trailing_update(trail, q, w, next_width=3, out=out_buf[..., :, :8])
    dense_new, dense_s = ref.trailing_update(trail.contiguous(), q, w, next_width=3)
    assert a_new.data_ptr() == out_buf.data_ptr()
    assert torch.equal(out_buf[..., :, :8], dense_new) and not out_buf[..., :, 8:].any()
    assert torch.equal(s, dense_s)
    assert torch.equal(tmod.panel_cross(trail, split=3),
                       ref.panel_cross(trail.contiguous(), split=3))
    assert _launch.strided("op", "a", trail) == (30 * 11, 11)
    assert _launch.strided("op", "a", out_buf[..., :, :8]) == (30 * 12, 12)
    assert _launch.strided("op", "a", torch.zeros(2, 3, 5, 4)[:, :, :, 1:]) == (20, 4)
    with pytest.raises(ValueError, match="collapse"):
        _launch.strided("op", "a", torch.zeros(3, 2, 5, 4).transpose(0, 1))
    with pytest.raises(ValueError, match="unit column stride"):
        _launch.strided("op", "a", torch.zeros(4, 6).T)


def test_batched_a_new_equals_per_slice_calls_at_the_c8_case():
    """ROADMAP C.8: at batch 2, m 5, n_t 3, b 1, float32, seed 0 the
    reference's vmapped ``ops.trailing_update(use_pallas=True)`` and its
    per-slice calls differ in the last bit of A_new (0.70097554 against
    0.7009756, tests/test_trailing_property.py::
    test_batch_dims_match_stacked_singles).  The port's batched call holds
    that contract: at b = 1 each entry of A_new is one product and one
    subtraction, so no summation order enters.  S is not compared: the
    plain version forms it with a batched product whose order the host's
    BLAS picks per shape (chip_smoke.py holds S on the card)."""
    batch, m, nt, b, seed = 2, 5, 3, 1, 0
    a, q, w = (torch.from_numpy(np.random.default_rng(seed + i).standard_normal(shape)
                                .astype(np.float32))
               for i, shape in enumerate([(batch, m, nt), (batch, m, b), (batch, b, nt)]))
    nw = min(3, nt)
    a_new, _ = ops.trailing_update(a, q, w, next_width=nw, use_pallas=True)
    for i in range(batch):
        ai, _ = ops.trailing_update(a[i], q[i], w[i], next_width=nw, use_pallas=True)
        assert torch.equal(a_new[i], ai)


@pytest.mark.parametrize("batch,m", [(1, 1), (8, 131072), (8, 1000), (64, 33), (1, 4096)])
def test_cross_split_covers_every_row_once(batch, m):
    rows, splits = _launch.cross_split(batch, m)
    assert rows % 32 == 0 and rows * (splits - 1) < m <= rows * splits
    assert 1 <= splits <= 65535


# The cross kernels' split at the blocked QR's shapes: panel_cross,
# trailing_update's lookahead and pad_cross's real columns are summed over
# these rows in order, so the blocked R bits and pipeline == eager rest on
# them: a change must be deliberate, never a side effect of a redesign.
@pytest.mark.parametrize("batch,m,want", [(8, 1 << 17, (4000, 33)), (1, 1000, (32, 32))])
def test_cross_split_is_pinned_at_the_main_path_shapes(batch, m, want):
    assert _launch.cross_split(batch, m) == want


def test_traffic_records_equal_reference(rng):
    """Same ops, sweeps and bytes per call as the reference."""
    (ja, ta), (jq, tq), (jw, tw) = _operands(rng, (4,), 32, 4, 10, "float32")
    with jtraffic.track_traffic() as jt:
        jops.panel_cross(ja, split=4)
        jops.pad_cross(ja, split=4, out_width=12)
        jops.trailing_update(ja, jq, jw)
        jops.trailing_update(ja, jq, jw, next_width=4)
    with traffic.track_traffic() as tt:
        ops.panel_cross(ta, split=4)
        ops.pad_cross(ta, split=4, out_width=12)
        ops.trailing_update(ta, tq, tw)
        ops.trailing_update(ta, tq, tw, next_width=4)
        with traffic.suppress():
            ops.panel_cross(ta, split=4)
    strip = [{k: v for k, v in r.items() if k != "traces"} for r in jt.records]
    assert [{k: v for k, v in r.items() if k != "traces"} for r in tt.records] == strip
    assert tt.sweeps_of("panel_cross", "pad_cross", "trailing_update") == 4
    assert tt.sweeps_of("trailing_update") == jt.sweeps_of("trailing_update") == 2


def test_cpu_tensors_count_no_launch(rng):
    (_, ta), (_, tq), (_, tw) = _operands(rng, (2,), 16, 3, 6, "float32")
    dispatch.launches.reset()
    ops.trailing_update(ta, tq, tw, next_width=3, use_pallas=True)
    ops.panel_cross(ta, split=3, use_pallas=True)
    ops.pad_cross(ta, split=3, out_width=8, use_pallas=True)
    assert dispatch.launches.as_dict() == {
        "gram": 0, "fused_apply_gram": 0, "apply_right": 0,
        "trailing_update": 0, "panel_cross": 0, "pad_cross": 0, "combine_gram": 0,
    }


def test_wrappers_reject_what_the_kernels_do_not_take():
    a, q, w = torch.zeros(2, 8, 6), torch.zeros(2, 8, 3), torch.zeros(2, 3, 6)
    with pytest.raises(ValueError, match="next_width"):
        tmod.trailing_update(a, q, w, next_width=7)
    with pytest.raises(ValueError, match=r"\(2, 3, 6\)"):
        tmod.trailing_update(a, q, torch.zeros(2, 4, 6))
    with pytest.raises(TypeError, match="must match"):
        tmod.trailing_update(a, q.bfloat16(), w)
    with pytest.raises(ValueError, match="out must be"):
        tmod.trailing_update(a, q, w, out=torch.zeros(2, 8, 5))
    with pytest.raises(ValueError, match="512"):
        tmod.panel_cross(torch.zeros(8, 600), split=4)
    with pytest.raises(ValueError, match="split"):
        tmod.panel_cross(a, split=0)
    with pytest.raises(ValueError, match="out_width"):
        tmod.pad_cross(a, split=3, out_width=5)
    with pytest.raises(TypeError, match="dtype"):
        tmod.panel_cross(a.double(), split=3)
    with pytest.raises(ValueError, match="meta"):
        tmod.panel_cross(torch.zeros(8, 4, device="meta"), split=2)
