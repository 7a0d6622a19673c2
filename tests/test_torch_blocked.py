"""The port's blocked QR (``factorize`` with ``panel_width``) against the JAX
package's on the same row blocks, fault-free: every variant, the
``fuse``/``pipeline`` schedules, the ``local_r`` choices, the kernel route,
the 4-D batched route and the traffic records; and the plain route's
chunked polish Gram.  R and Q agree within 5e-4; plans, validity bits and
``PanelReport`` fields agree exactly.  Fault schedules are in
test_torch_blocked_faults.py."""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from blocked_parity import (  # noqa: E402
    SHAPES,
    TOL,
    VARIANTS,
    assert_same,
    blocks_of,
    both,
    check_fault_free,
    dense_r,
    schedules,
)
from repro.kernels import traffic as jtraffic  # noqa: E402
from repro.qr import QRConfig as JQRConfig  # noqa: E402
from repro.qr import factorize as jfactorize  # noqa: E402

from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import traffic  # noqa: E402
from repro_torch.qr import QRConfig, factorize  # noqa: E402
from repro_torch.qr import panel as tpanel  # noqa: E402


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "tree"])
def test_fault_free_matches_reference(rng, variant, shape):
    """Fault-free runs take the fixed-shape pipeline; ``tree`` (the eager
    driver) is in test_torch_blocked_faults.py."""
    check_fault_free(rng, variant, shape)


@pytest.mark.parametrize("pipeline,fuse", [("auto", "auto"), ("auto", "off"), ("auto", "on"),
                                           ("off", "auto"), ("off", "off"), ("on", "on")])
def test_schedules_match_reference_and_each_other(rng, pipeline, fuse):
    """Every driver and schedule gives the reference's result; within the
    port the fixed-shape pipeline, the eager driver and the split schedule
    agree (bit for bit on the card's kernel route, chip_smoke.py; to the CPU
    BLAS's width-dependent rounding here)."""
    blocks = blocks_of(rng, 8, 24, 17)
    cfg = dict(panel_width=5, compute_q=True)
    got, _ = both(blocks, pipeline=pipeline, fuse=fuse, **cfg)
    base = factorize(blocks, QRConfig(**cfg), device="cpu")
    np.testing.assert_allclose(got.r.numpy(), base.r.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.q.numpy(), base.q.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("local_r", ["chol", "jnp", "cqr2"])
def test_local_r_matches_reference(rng, local_r):
    blocks = blocks_of(rng, 4, 48, 20)
    got, _ = both(blocks, panel_width=6, local_r=local_r)
    np.testing.assert_allclose(got.r.numpy()[0], dense_r(blocks), **TOL)


@pytest.mark.parametrize("pipeline", ["auto", "off"])
def test_kernel_route_matches_reference(rng, pipeline):
    """``use_pallas=True`` (interpret-mode Pallas in the reference, the
    kernels' plain versions here) gives the plain route's result."""
    blocks = blocks_of(rng, 4, 40, 16)
    got, _ = both(blocks, panel_width=5, use_pallas=True, pipeline=pipeline, compute_q=True)
    plain = factorize(blocks, QRConfig(panel_width=5, pipeline=pipeline, compute_q=True),
                      device="cpu")
    np.testing.assert_allclose(got.r.numpy(), plain.r.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["redundant", "selfhealing"])
def test_batched_route_matches_reference(rng, variant):
    b = np.stack([blocks_of(rng, 4, 24, 10) for _ in range(3)])
    got = factorize(b, QRConfig(panel_width=4, variant=variant, compute_q=True), device="cpu")
    want = jfactorize(jnp.asarray(b), JQRConfig(panel_width=4, variant=variant, compute_q=True))
    assert tuple(got.valid.shape) == want.valid.shape == (3, 4)
    assert_same(got, want)
    single = factorize(b[1], QRConfig(panel_width=4, variant=variant), device="cpu")
    np.testing.assert_allclose(got.r.numpy()[1], single.r.numpy(), rtol=1e-5, atol=1e-5)


def _strip(records):
    return [{k: v for k, v in r.items() if k not in ("dispatches", "traces")} for r in records]


@pytest.mark.parametrize("case", [
    dict(pipeline="auto"), dict(pipeline="off"), dict(pipeline="auto", fuse="off"),
    dict(pipeline="auto", local_r="cqr2"), dict(faults=dict(update={0: {5: 1}})),
    dict(faults=dict(panel={0: {5: 1}}), recover="off"),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_traffic_records_equal_reference(rng, case):
    """Sweeps, bytes, rounds and wire bytes per record equal the
    reference's (the port launches each sweep as its own kernel, so the
    compiled pipeline's dispatch and trace counts are not compared)."""
    case = dict(case)
    tf, jf = schedules(case.pop("faults", None))
    blocks = blocks_of(rng, 8, 24, 17)
    with jtraffic.track_traffic() as jt:
        jfactorize(jnp.asarray(blocks), JQRConfig(panel_width=5, **case), faults=jf)
    with traffic.track_traffic() as tt:
        res = factorize(blocks, QRConfig(panel_width=5, **case), faults=tf, device="cpu")
    assert _strip(tt.records) == _strip(jt.records)
    assert tt.sweeps_of("panel_cross", "pad_cross", "trailing_update") == res.n_panels
    assert tt.rounds_of("panel_reduce") == jt.rounds_of("panel_reduce")
    assert tt.wire_bytes_of("panel_reduce", "reorth_reduce") == jt.wire_bytes_of(
        "panel_reduce", "reorth_reduce")


def test_batched_traffic_records_equal_reference(rng):
    b = np.stack([blocks_of(rng, 4, 24, 10) for _ in range(2)])
    with jtraffic.track_traffic() as jt:
        jfactorize(jnp.asarray(b), JQRConfig(panel_width=4))
    with traffic.track_traffic() as tt:
        factorize(b, QRConfig(panel_width=4), device="cpu")
    assert _strip(tt.records) == _strip(jt.records)


def test_chunked_polish_gram_agrees_with_plain_gram(rng):
    """The plain route's polish Gram sums 1024-row chunks (ROADMAP C4).

    It is held against the exact Gram, a float64 product of the same
    (f32 or bf16) input, and not against another f32 summation order such
    as ``kref.gram``, whose order is the host BLAS's choice.  Each chunked
    element is a chain of at most 1024 + 3 f32 terms (a chunk's products,
    then the chunk sum): a typical rounding error of √n·2⁻²⁴ ≈ 2e-6 and an
    order-free bound γ₁₀₂₇ ≈ 6.1e-5 relative to the sum of |terms|, which
    for a Gram's diagonal is max|G|.  1e-5 of max|G| holds on any BLAS, and
    a dropped chunk or a bad pad, which are off by O(1), still fail it.
    """
    for shape in [(3, 2500, 7), (2, 100, 5), (4096, 16)]:
        q = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        for x in (q, q.bfloat16()):
            got = tpanel.chunked_gram(x)
            x64 = x.double()
            want = x64.mT @ x64
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert ((got.double() - want).abs().max() / want.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("cfg,want", [
    (dict(panel_width=4), {}),
    (dict(panel_width=4, local_r="cqr2"), {}),
    (dict(panel_width=4, use_pallas=True), {"gram": 3, "panel_cross": 1, "trailing_update": 2}),
    (dict(panel_width=5, use_pallas=True, fuse="off"),
     {"gram": 3, "pad_cross": 1, "trailing_update": 2}),
    (dict(panel_width=4, use_pallas=True, pipeline="off"),
     {"gram": 3, "panel_cross": 1, "trailing_update": 2}),
], ids=["plain", "cqr2", "kernels", "kernels-ragged", "kernels-eager"])
def test_only_the_kernel_route_reaches_the_kernels(monkeypatch, rng, cfg, want):
    """``use_pallas`` puts the prime, the K − 1 trailing sweeps and every
    panel's polish Gram on the kernel wrappers (one call each for all P
    ranks); the plain route calls none.  PanelFactorizer decides the polish
    Gram in one place."""
    from repro_torch.kernels import ops as kops

    calls = collections.Counter()

    def spy(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    for mod, attr, name in [(tpanel, "gram", "gram"), (kops, "_gram_kernel", "gram"),
                            (kops, "_fused_kernel", "fused_apply_gram"),
                            (kops, "_trailing_kernel", "trailing_update"),
                            (kops, "_panel_cross_kernel", "panel_cross"),
                            (kops, "_pad_cross_kernel", "pad_cross")]:
        monkeypatch.setattr(mod, attr, spy(name, getattr(mod, attr)))
    config = QRConfig(compute_q=True, **cfg)
    got = factorize(blocks_of(rng, 4, 16, 12), config, device="cpu")
    assert dict(calls) == want
    assert config.factorizer().kernel_gram == bool(cfg.get("use_pallas"))
    q = got.q.numpy().reshape(-1, 12).astype(np.float64)
    assert np.abs(q.T @ q - np.eye(12)).max() < 5e-5
    assert not QRConfig(use_pallas=True).factorizer().kernel_gram       # TSQR ignores it
    assert QRConfig(local_r="cqr2_pallas").factorizer().kernel_gram
