"""The port's ``factorize`` (TSQR) against the JAX package's on the same
row blocks: every variant × local QR × fault picture, with and without Q,
the batched route, the quickstart scenario, and the facade's routing and
validation."""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from repro.collective import FaultSpec as JFaultSpec  # noqa: E402
from repro.qr import QRConfig as JQRConfig  # noqa: E402
from repro.qr import factorize as jfactorize  # noqa: E402

from repro_torch.collective import FaultSpec  # noqa: E402
from repro_torch.core import ref  # noqa: E402
from repro_torch.qr import QRConfig, factorize  # noqa: E402
from repro_torch.qr import api as tapi  # noqa: E402

VARIANTS = ("tree", "redundant", "replace", "selfhealing")
LOCAL_R = ("jnp", "cqr2", "cqr2_pallas")
# (P, m_local, n, deaths): fault-free, one death inside tolerance, a
# death at entry of exchange 0, and a pair striking one block.
PICTURES = [(2, 24, 6, {}), (4, 32, 8, {2: 1}), (8, 16, 5, {}), (8, 16, 5, {5: 1}),
            (8, 16, 5, {0: 0}), (8, 16, 5, {4: 2, 5: 2})]
TOL = dict(rtol=5e-4, atol=5e-4)


def _both(blocks, variant, local_r, deaths, compute_q=False):
    faults = (FaultSpec.of(deaths), JFaultSpec.of(deaths)) if deaths else (None, None)
    got = factorize(blocks, QRConfig(variant=variant, local_r=local_r, compute_q=compute_q),
                    faults=faults[0], device="cpu")
    want = jfactorize(jnp.asarray(blocks),
                      JQRConfig(variant=variant, local_r=local_r, compute_q=compute_q),
                      faults=faults[1])
    return got, want


@pytest.mark.parametrize("local_r", LOCAL_R)
@pytest.mark.parametrize("variant", VARIANTS)
def test_factorize_matches_reference(rng, variant, local_r):
    for p, m, n, deaths in PICTURES:
        blocks = ref.random_tall_skinny(rng, p, m, n)
        truth = ref.qr_r(blocks.reshape(-1, n).astype(np.float64))
        got, want = _both(blocks, variant, local_r, deaths)
        valid = got.valid.numpy()
        np.testing.assert_array_equal(valid, np.asarray(want.valid))
        np.testing.assert_array_equal(valid, got.plan.final_valid)
        r, wr = got.r.numpy(), np.asarray(want.r)
        np.testing.assert_array_equal(np.isnan(r), np.isnan(wr))
        assert got.plan.message_count() == want.plan.message_count()
        for i in np.flatnonzero(valid):
            np.testing.assert_allclose(r[i], wr[i], **TOL)
            np.testing.assert_allclose(r[i], truth, **TOL)
        if got.plan.final_valid.all():
            got, want = _both(blocks, variant, local_r, deaths, compute_q=True)
            np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), **TOL)
            np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), **TOL)
            q = got.q.numpy().reshape(-1, n).astype(np.float64)
            assert np.abs(q.T @ q - np.eye(n)).max() < 2e-5


def test_quickstart_scenario():
    """examples/quickstart.py on the port: rank 5 dies at the entry of
    exchange 1 of the redundant butterfly; the survivors hold the right R."""
    rng = np.random.default_rng(0)
    p, m_local, n = 8, 512, 32
    blocks = ref.random_tall_skinny(rng, p, m_local, n)
    truth = ref.qr_r(blocks.reshape(-1, n).astype(np.float64))
    got, want = _both(blocks, "redundant", "jnp", {5: 1})
    valid = got.valid.numpy()
    assert valid.tolist() == np.asarray(want.valid).tolist() == [True, False] * 4
    for r in np.flatnonzero(valid):
        assert np.abs(got.r.numpy()[r] - truth).max() < 1e-3
    assert got.plan.message_count() == want.plan.message_count() == 24
    assert got.plan.round_count() == want.plan.round_count() == 3
    tensor_in = factorize(torch.from_numpy(blocks), QRConfig(variant="redundant"),
                          faults=FaultSpec.of({5: 1}), device="cpu")
    assert torch.equal(torch.nan_to_num(tensor_in.r), torch.nan_to_num(got.r))


@pytest.mark.parametrize("local_r", LOCAL_R)
def test_batched_route_matches_reference(rng, local_r):
    b = np.stack([ref.random_tall_skinny(rng, 4, 24, 6) for _ in range(3)])
    got = factorize(b, QRConfig(local_r=local_r, compute_q=True), device="cpu")
    want = jfactorize(jnp.asarray(b), JQRConfig(local_r=local_r, compute_q=True))
    assert tuple(got.r.shape) == want.r.shape and tuple(got.valid.shape) == want.valid.shape
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), **TOL)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), **TOL)
    single = factorize(b[1], QRConfig(local_r=local_r), device="cpu")
    np.testing.assert_allclose(got.r.numpy()[1], single.r.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("local_r,want", [
    ("jnp", {}),
    ("cqr2", {}),
    ("cqr2_pallas", {"gram": 2, "fused_apply_gram": 1}),
])
def test_only_the_kernel_route_reaches_the_kernels(monkeypatch, rng, local_r, want):
    """With ``compute_q``, only ``local_r="cqr2_pallas"`` calls a kernel
    wrapper (its local QR, then Q's polish Gram); the other routes run the
    plain products, as the reference does, and so need no kernel on a card."""
    from repro_torch.kernels import ops as kops
    from repro_torch.qr import panel

    calls = collections.Counter()

    def spy(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    for mod, attr, name in [(panel, "gram", "gram"), (kops, "_gram_kernel", "gram"),
                            (kops, "_fused_kernel", "fused_apply_gram"),
                            (kops, "_apply_kernel", "apply_right")]:
        monkeypatch.setattr(mod, attr, spy(name, getattr(mod, attr)))
    got = factorize(ref.random_tall_skinny(rng, 4, 16, 5),
                    QRConfig(local_r=local_r, compute_q=True), device="cpu")
    assert dict(calls) == want
    q = got.q.numpy().reshape(-1, 5).astype(np.float64)
    assert np.abs(q.T @ q - np.eye(5)).max() < 2e-5


BAD_CONFIGS = [
    dict(variant="bogus"), dict(local_r="bogus"), dict(reorth=-1), dict(panel_width=0),
    dict(block_rows=0), dict(local_r="chol"), dict(parity=0), dict(gram=True, panel_width=4),
    dict(redundancy="coded", gram=True), dict(redundancy="coded", pipeline="on"),
    dict(fuse="sideways"),
]


@pytest.mark.parametrize("kwargs", BAD_CONFIGS, ids=lambda kw: "-".join(map(str, kw.items())))
def test_config_validation_matches_reference(kwargs):
    with pytest.raises(ValueError) as want:
        JQRConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        QRConfig(**kwargs)
    assert type(got.value) is type(want.value)


def test_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(QRConfig)] == [
        f.name for f in dataclasses.fields(JQRConfig)
    ]
    assert QRConfig().resolved_local_r() == JQRConfig().resolved_local_r() == "jnp"
    assert QRConfig(pipeline="OFF").pipeline is tapi.Pipeline.OFF


@pytest.mark.parametrize("config,kwargs,item", [
    (QRConfig(), {"mesh": object()}, "cannot route"),
    (QRConfig(gram=True), {}, "shard_map-only"),
])
def test_later_slices_raise_not_implemented(config, kwargs, item):
    """Both routes are ported now; what is left is the reference's own
    refusal: row blocks with a mesh, and the Gram butterfly without one,
    raise its ValueError (the name stays)."""
    blocks = np.zeros((2, 8, 2), np.float32)
    jconfig = JQRConfig(gram=config.gram)
    with pytest.raises(ValueError, match=item) as want:
        jfactorize(jnp.asarray(blocks), jconfig, **kwargs)
    with pytest.raises(ValueError, match=item) as got:
        factorize(blocks, config, device="cpu", **kwargs)
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


@pytest.mark.parametrize("fields,shape,kwargs", [
    (dict(), (2, 2, 8, 2), {}),                        # a batch
    (dict(panel_width=2), (2, 2, 8, 2), {}),
    (dict(), (16, 2), {"mesh": object()}),             # a mesh, refused for good
    (dict(panel_width=2), (16, 2), {"mesh": object()}),
])
def test_coded_refusals_match_reference(fields, shape, kwargs):
    """The coded scheme refuses batches and meshes with the reference's
    ValueError (the mesh refusal comes before the route check)."""
    blocks = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as want:
        jfactorize(jnp.asarray(blocks), JQRConfig(redundancy="coded", **fields), **kwargs)
    with pytest.raises(ValueError) as got:
        factorize(blocks, QRConfig(redundancy="coded", **fields), device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


def test_routing_errors(rng):
    blocks = ref.random_tall_skinny(rng, 4, 8, 3)
    with pytest.raises(ValueError, match="cannot route"):
        factorize(blocks[0], device="cpu")
    with pytest.raises(TypeError, match="FaultSpec"):
        factorize(blocks, faults={1: 1}, device="cpu")
    with pytest.raises(ValueError, match="fault-free"):
        factorize(blocks[None], faults=FaultSpec.of({1: 1}), device="cpu")
    with pytest.raises(ValueError, match="compute_q"):
        factorize(blocks, QRConfig(compute_q=True), faults=FaultSpec.of({1: 1}), device="cpu")
    with pytest.raises(TypeError, match="QRConfig"):
        factorize(blocks, {"variant": "tree"}, device="cpu")


def test_default_device_is_the_card(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        factorize(ref.random_tall_skinny(rng, 2, 8, 3))
    assert tapi.resolve_device("cpu") == torch.device("cpu")
