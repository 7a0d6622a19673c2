"""The port's blocked QR under fault schedules, against the JAX package's on
the same row blocks: panel-phase and update-phase deaths in every variant
under the fused and split schedules, cascading and beyond-tolerance deaths,
NaN poisoning under ``recover="off"``, and the reference's validation
errors.  Validity bits, NaN masks and every ``PanelReport`` field agree
exactly; finite R entries within 5e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from blocked_parity import (  # noqa: E402
    SHAPES,
    TOL,
    VARIANTS,
    blocks_of,
    both,
    check_fault_free,
    dense_r,
    schedules,
)
from repro.qr import QRConfig as JQRConfig  # noqa: E402
from repro.qr import factorize as jfactorize  # noqa: E402

from repro_torch.collective import FaultSpec  # noqa: E402
from repro_torch.qr import PanelFaultSchedule, QRConfig, factorize  # noqa: E402


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tree_fault_free_matches_reference(rng, shape):
    """``tree``'s fault-free plans leave non-root ranks invalid, so it runs
    the eager driver, as fault schedules do."""
    check_fault_free(rng, "tree", shape)


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_panel_phase_death_matches_reference(rng, variant, fuse):
    blocks = blocks_of(rng, 8, 32, 15)
    got, _ = both(blocks, faults=dict(panel={1: {2: 1}}), panel_width=4, variant=variant,
                   fuse=fuse)
    truth = dense_r(blocks)
    for r in np.flatnonzero(got.valid.numpy()):
        np.testing.assert_allclose(got.r.numpy()[r], truth, **TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_update_phase_death_matches_reference(rng, variant):
    """A death in panel 0's cross-product butterfly: that panel runs the
    split schedule, the others stay fused."""
    blocks = blocks_of(rng, 8, 32, 15)
    got, _ = both(blocks, faults=dict(update={0: {5: 1}}), panel_width=4, variant=variant)
    assert [rep.fused for rep in got.reports] == [False, True, True, True]
    valid = got.valid.numpy()
    if variant == "redundant":
        assert valid.sum() == 4                 # rank 5's step-1 coset dies
    truth = dense_r(blocks)
    for r in np.flatnonzero(valid):
        np.testing.assert_allclose(got.r.numpy()[r], truth, **TOL)


def test_cascading_deaths_and_beyond_tolerance_match_reference(rng):
    blocks = blocks_of(rng, 8, 32, 15)
    got, _ = both(blocks, faults=dict(panel={0: {1: 1}, 1: {6: 2}, 2: {3: 1}}),
                   panel_width=4, variant="selfhealing")
    assert got.valid.numpy().all() and all(rep.within_tolerance for rep in got.reports)
    # a death at the entry of exchange 0 is beyond every variant's tolerance
    got, _ = both(blocks, faults=dict(update={0: {3: 0}}), panel_width=4, fuse="off")
    assert not got.reports[0].within_tolerance_w


@pytest.mark.parametrize("faults", [dict(panel={0: {5: 1}}), dict(update={1: {5: 1}})],
                         ids=["panel", "update"])
def test_no_recovery_poisons_like_reference(rng, faults):
    """recover='off': the NaN-poisoned rank's contributions rot every later
    panel on the same ranks and entries as in the reference."""
    blocks = blocks_of(rng, 8, 32, 15)
    got, _ = both(blocks, faults=faults, panel_width=4, recover="off")
    assert all(rep.recovered_r + rep.recovered_w == 0 for rep in got.reports)
    assert np.isnan(got.r.numpy()).any()
    healed, _ = both(blocks, faults=faults, panel_width=4)
    r0 = healed.r.numpy()[np.flatnonzero(healed.valid.numpy())[0]]
    np.testing.assert_allclose(r0, dense_r(blocks), **TOL)


def _raises_like(exc, match, blocks, cfg, faults=None):
    tf, jf = schedules(faults)
    with pytest.raises(exc, match=match):
        jfactorize(jnp.asarray(blocks), JQRConfig(**cfg), faults=jf)
    with pytest.raises(exc, match=match):
        factorize(blocks, QRConfig(**cfg), faults=tf, device="cpu")


@pytest.mark.parametrize("shape,cfg,faults,match", [
    ((4, 16, 8), dict(panel_width=4), dict(panel={9: {0: 1}}), "panel 9"),
    ((4, 16, 8), dict(panel_width=4), dict(update={1: {0: 1}}), "last panel"),
    ((4, 6, 8), dict(panel_width=8), None, "row block"),
    ((4, 16, 8), dict(panel_width=4, fuse="on"), dict(update={0: {1: 1}}), "Fuse.ON"),
    ((4, 16, 8), dict(panel_width=4, pipeline="on"), dict(panel={0: {1: 1}}), "Pipeline.ON"),
], ids=["missing-panel", "last-panel-update", "tall-panel", "fuse-on", "pipeline-on"])
def test_validation_errors_match_reference(rng, shape, cfg, faults, match):
    _raises_like(ValueError, match, blocks_of(rng, *shape), cfg, faults)


def test_routing_errors(rng):
    blocks = blocks_of(rng, 4, 16, 8)
    with pytest.raises(TypeError, match="PanelFaultSchedule"):
        factorize(blocks, QRConfig(panel_width=4), faults=FaultSpec.of({1: 1}), device="cpu")
    with pytest.raises(ValueError, match="fault-free"):
        factorize(blocks[None], QRConfig(panel_width=4),
                  faults=PanelFaultSchedule.of(panel={0: {1: 1}}), device="cpu")
    with pytest.raises(ValueError, match="pipeline-eligible"):
        factorize(blocks[None], QRConfig(panel_width=4, variant="tree"), device="cpu")
    # the mesh route takes this rank's 2-D block: row blocks with a mesh
    # raise the reference's route error
    with pytest.raises(ValueError, match="cannot route input of shape"):
        factorize(blocks, QRConfig(panel_width=4), mesh=object(), device="cpu")
