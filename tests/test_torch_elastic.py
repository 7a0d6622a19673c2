"""Elastic recovery on the port (``repro_torch.runtime.elastic`` and the
trainer over several replicas) against the JAX package's on the CPU: every
case of ``tests/test_elastic.py``, the three stock trainer scenarios, and
the replica-axis gradient functions at R = 4 (mesh-free on both sides).

The reference needs a JAX device per replica, so its multi-replica runs go
through a subprocess with 8 forced host devices
(``trainer_parity.reference_subprocess``), once per module; the port runs
them in this process from the reference's initial states.
Meshes are compared by each slot's place in the template's flat order (a
device id of the reference, a replica-slot id of the port).  Tolerances:
``trainer_parity``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax  # noqa: E402
from repro.bench import scenarios as jscen  # noqa: E402
from repro.collective import FaultSpec as JFaultSpec  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402

import model_parity as mp  # noqa: E402
import trainer_parity as tp  # noqa: E402
from repro_torch.bench import scenarios as tscen  # noqa: E402
from repro_torch.collective import FaultSpec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import dispatch as tdispatch  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim._tree import leaves  # noqa: E402
from repro_torch.runtime import trainer  # noqa: E402
from repro_torch.runtime.elastic import ReplicaMesh, rebuild_mesh, shrink_mesh  # noqa: E402

TRAINER_SCENARIOS = [sc.name for sc in tscen.get_scenarios() if sc.kind == "trainer"]




@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.reference_subprocess(tmp_path_factory.mktemp("elastic"),
                                   ["topology", "scenarios", "shrink_dead"])


def _slots(m: ReplicaMesh, template: ReplicaMesh) -> list[int]:
    return tp.positions([int(i) for i in m.ids.flat], [int(i) for i in template.ids.flat])


# ---------------------------------------------------------------------------
# Topology (tests/test_elastic.py)
# ---------------------------------------------------------------------------

def test_shrink_mesh_power_of_two_widths_and_exhaustion(reference):
    mesh = ReplicaMesh.of((8, 1))
    ladder, m = [], mesh
    while m is not None:
        m = shrink_mesh(m)
        ladder.append(None if m is None else (m.axis_names, m.shape, _slots(m, mesh)))
    assert ladder == reference["ladder"]
    # default halving walks the power-of-two ladder down to 1, then None
    assert [x and x[1][0] for x in ladder] == [4, 2, 1, None]
    # drop_replicas keeps halving until enough replicas are gone
    drop = {k: (lambda s: None if s is None else s.shape)(shrink_mesh(mesh, drop_replicas=k))
            for k in range(1, 9)}
    assert drop == reference["drop"]
    assert [drop[k] and drop[k][0] for k in (1, 4, 5, 7, 8)] == [4, 4, 2, 1, None]
    # the survivors are the leading slice of the original slots
    assert (shrink_mesh(mesh).ids == mesh.ids[:4]).all()
    # no data axis -> nothing to shrink
    assert shrink_mesh(ReplicaMesh.of((8,), ("model",))) is None
    assert reference["no_data_axis"] is None


def test_rebuild_mesh_roundtrips_template(reference):
    mesh = ReplicaMesh.of((4, 2))
    small, full = shrink_mesh(mesh), rebuild_mesh(mesh)     # the template, not the shrunk mesh
    got = (small.shape, _slots(small, mesh), full.axis_names, full.shape, _slots(full, mesh))
    assert got == reference["rebuild"]
    assert small.shape == (2, 2) and (full.ids == mesh.ids).all() and full is not mesh


def test_mesh_fingerprint_is_the_equivalence_class():
    from repro_torch.runtime.elastic import mesh_fingerprint

    mesh = ReplicaMesh.of((4, 1))
    assert mesh_fingerprint(rebuild_mesh(mesh)) == mesh_fingerprint(mesh)
    assert mesh_fingerprint(mesh) == (("data", "model"), (4, 1), (0, 1, 2, 3))
    assert mesh_fingerprint(shrink_mesh(mesh)) != mesh_fingerprint(mesh)
    hash(mesh_fingerprint(mesh))


def _port_case(name, reference, tmp_path):
    return tp.port_run(tp.ELASTIC_CASES[name], str(tmp_path / "ck"), reference[name]["init"])


def test_shrink_excludes_dead_replica(reference, tmp_path):
    """SHRINK must drop the failed replica's slot, not just halve the
    leading slice (which would keep the dead hardware in the mesh)."""
    got = _port_case("shrink_dead", reference, tmp_path)
    tp.assert_same_run(got, reference["shrink_dead"])
    assert got["n_replicas"] == 2 and 1 not in got["mesh_ids"], got["mesh_ids"]
    assert "elastic shrink → mesh {'data': 2, 'model': 1}" in got["events"]


# ---------------------------------------------------------------------------
# The stock trainer scenarios
# ---------------------------------------------------------------------------

def test_the_trainer_scenarios_are_the_reference_ones():
    want = {sc.name: sc for sc in jscen.get_scenarios() if sc.kind == "trainer"}
    assert TRAINER_SCENARIOS == list(want) == ["fail_during_rebuild", "buddy_pair_wipe",
                                               "shrink_then_rebuild"]
    for name in TRAINER_SCENARIOS:
        got = next(sc for sc in tscen.get_scenarios() if sc.name == name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want[name])
        assert got.kind == "trainer"


EXPECTED_COUNTS = {"fail_during_rebuild": 12, "buddy_pair_wipe": 9, "shrink_then_rebuild": 8}


@pytest.mark.parametrize("name", TRAINER_SCENARIOS)
def test_trainer_scenario_matches_reference(name, reference, tmp_path):
    """The scenario through ``trainer_scenario_run`` from the reference's
    initial state: the same run (every step's loss; the runner keeps no
    final parameters), and ``trainer_scenario_metrics`` equal to the
    reference's ``run_trainer_scenario`` metrics as a dict."""
    want = reference["scenario:" + name]
    sc = next(s for s in tscen.get_scenarios() if s.name == name)
    with tdispatch.track_dispatch() as d:
        tr = tscen.trainer_scenario_run(sc, str(tmp_path / "ck"), device="cpu",
                                        state=tp.port_state(want["init"]))
    got = tp._summary(tr, d.traces, d.dispatches, [])
    got["mesh_ids"] = [int(i) for i in tr.mesh.ids.flat]
    got["template_ids"] = [int(i) for i in tr._template_mesh.ids.flat]
    tp.assert_same_run(got, want, final=False)
    metrics = {k: (m.value, m.gate, m.direction, m.unit, m.tolerance)
               for k, m in tscen.trainer_scenario_metrics(sc, tr).items()}
    assert metrics == want["metrics"]
    assert metrics["loss_finite"][0] is True
    traces = 2 if name == "shrink_then_rebuild" else 1   # the rejoin hits the step cache
    assert got["traces"] == {"train_step": traces}
    assert got["dispatches"] == {"train_step": EXPECTED_COUNTS[name]}


def test_run_trainer_scenario_raises_on_a_missed_expectation():
    sc = next(s for s in tscen.get_scenarios() if s.name == "shrink_then_rebuild")
    wrong = dataclasses.replace(sc, expect={"failures": 2}, steps=4)
    with pytest.raises(tscen.BenchFailure, match="fault_stats\\['failures'\\] = 1"):
        tscen.run_trainer_scenario(wrong, device="cpu")
    assert tscen.run_scenario(dataclasses.replace(sc, steps=4, expect={"shrinks": 1}),
                              device="cpu")["final_replicas"].value == 2


# ---------------------------------------------------------------------------
# The replica-axis gradient functions at R = 4 (mesh-free on both sides)
# ---------------------------------------------------------------------------

R = 4


@pytest.fixture(scope="module")
def grads_case():
    """olmo-1b smoke (one layer), 8 rows of 16 tokens, replica 2 blanked by
    its loss weights; the reference's replica_grads, ft_replica_grad
    fault-free and with rank 2 dying at exchange 1 ({2: 1}: slot 0 is not
    valid then)."""
    jcfg = jget("olmo-1b").smoke(n_layers=1)
    jp = mp.ref_params(jcfg, 3)
    batch = mp.batch_np(jcfg, 2 * R, 16, seed=4)
    weight = np.ones(2 * R, np.float32)
    weight[4:6] = 0.0
    batch["loss_weight"] = weight / weight.mean()

    def loss(p, b):
        return japi.loss_fn(p, b, jcfg)

    @jax.jit
    def run(p, b):                       # one program: eager JAX takes ~18 s here
        losses, grads, live, n_live = jtrainer.replica_grads(loss, p, b, R)
        return (losses, grads, live, n_live, jtrainer.mask_replica_tree(grads, live, R),
                jtrainer.ft_replica_grad(loss, p, b, R),
                jtrainer.ft_replica_grad(loss, p, b, R, fault_spec=JFaultSpec.of({2: 1})))

    losses, grads, live, n_live, masked, ft, ft_death = run(jp, mp.to_jax(batch))
    out = {"jp": jp, "batch": batch, "losses": np.asarray(losses), "live": np.asarray(live),
           "n_live": float(n_live), "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
           "masked": [np.asarray(g) for g in jax.tree.leaves(masked)]}
    for key, (lv, g) in (("ft", ft), ("ft_death", ft_death)):
        out[key] = (float(lv), [np.asarray(x) for x in jax.tree.leaves(g)])
    return out


def _port_loss(cfg):
    return lambda p, b: api.loss_fn(p, b, cfg)


def _close(got, want, tol=mp.GRAD_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert mp.rel_err(g, w) <= tol


def test_replica_grads_match_reference(grads_case):
    cfg = get_config("olmo-1b").smoke(n_layers=1)
    params, batch = mp.to_port(grads_case["jp"]), mp.to_port(grads_case["batch"])
    losses, grads, live, n_live = trainer.replica_grads(_port_loss(cfg), params, batch, R)
    np.testing.assert_allclose(losses.numpy(), grads_case["losses"], rtol=tp.LOSS_RTOL)
    assert live.tolist() == grads_case["live"].tolist() == [True, True, False, True]
    assert n_live.dtype == torch.float32 and float(n_live) == grads_case["n_live"] == 3.0
    _close(leaves(grads), grads_case["grads"])
    masked = leaves(trainer.mask_replica_tree(grads, live, R))
    _close(masked, grads_case["masked"])
    assert all(not g[2].any() for g in masked)         # the dead replica's slice is zero
    assert all(g[2].abs().max() > 0 for g in leaves(grads))   # its z-loss gradient was not


@pytest.mark.parametrize("key", ["ft", "ft_death"])
def test_ft_replica_grad_matches_reference(grads_case, key):
    cfg = get_config("olmo-1b").smoke(n_layers=1)
    params, batch = mp.to_port(grads_case["jp"]), mp.to_port(grads_case["batch"])
    spec = FaultSpec.of({2: 1}) if key == "ft_death" else None
    loss, grads = trainer.ft_replica_grad(_port_loss(cfg), params, batch, R, fault_spec=spec)
    want_loss, want_grads = grads_case[key]
    np.testing.assert_allclose(float(loss), want_loss, rtol=tp.LOSS_RTOL)
    _close(leaves(grads), want_grads)
    assert all(g.dtype == torch.float32 for g in leaves(grads))


def test_ft_replica_grad_is_the_live_mean(grads_case):
    """The butterfly's sum over live replicas, read from a valid slot, is
    the plain mean of the live replicas' gradients."""
    cfg = get_config("olmo-1b").smoke(n_layers=1)
    params, batch = mp.to_port(grads_case["jp"]), mp.to_port(grads_case["batch"])
    _, grads = trainer.ft_replica_grad(_port_loss(cfg), params, batch, R,
                                       fault_spec=FaultSpec.of({2: 1}))
    _, per, live, n_live = trainer.replica_grads(_port_loss(cfg), params, batch, R)
    for g, p in zip(leaves(grads), leaves(per)):
        want = p[live].sum(0) / n_live
        assert torch.allclose(g, want, rtol=1e-6, atol=1e-7 * float(want.abs().max()))


def test_ft_replica_grad_past_tolerance_raises(grads_case):
    cfg = get_config("olmo-1b").smoke(n_layers=1)
    params, batch = mp.to_port(grads_case["jp"]), mp.to_port(grads_case["batch"])
    jspec, spec = JFaultSpec.of({0: 0, 1: 0}), FaultSpec.of({0: 0, 1: 0})
    with pytest.raises(ValueError, match="exceeds the butterfly's tolerance"):
        jtrainer.ft_replica_grad(lambda p, b: japi.loss_fn(p, b, jget("olmo-1b").smoke(
            n_layers=1)), grads_case["jp"], mp.to_jax(grads_case["batch"]), R, fault_spec=jspec)
    with pytest.raises(ValueError, match="exceeds the butterfly's tolerance"):
        trainer.ft_replica_grad(_port_loss(cfg), params, batch, R, fault_spec=spec)


def test_value_and_grad_leaves_the_parameters_alone():
    cfg = get_config("olmo-1b").smoke(n_layers=1)
    params = api.init(0, cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in mp.batch_np(cfg, 2, 8, seed=0).items()}
    loss, grads = trainer.value_and_grad(_port_loss(cfg), params, batch)
    assert not loss.requires_grad and not any(p.requires_grad for p in leaves(params))
    assert [g.shape for g in leaves(grads)] == [p.shape for p in leaves(params)]
