"""Each stock fault scenario of the port against the JAX package's
``run_collective_scenario`` / ``run_blocked_qr_scenario`` on the same
scenario and seed: the same metric names, values, gates and units."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
from repro.bench import scenarios as jscen  # noqa: E402

from repro_torch.bench import scenarios as tscen  # noqa: E402

# the collective and blocked scenarios; the trainer ones are held against
# the reference in test_torch_elastic.py (they need several JAX devices)
NAMES = [sc.name for sc in tscen.get_scenarios() if sc.kind != "trainer"]


def _reference(name):
    return next(sc for sc in jscen.get_scenarios() if sc.name == name)


def _as_dict(metrics):
    return {k: (m.value, m.gate, m.direction, m.unit, m.tolerance) for k, m in metrics.items()}


@pytest.mark.parametrize("name", NAMES)
def test_scenario_equals_reference(name):
    got_sc = next(sc for sc in tscen.get_scenarios() if sc.name == name)
    want_sc = _reference(name)
    # the same scenario, field by field
    assert dataclasses.asdict(got_sc) == dataclasses.asdict(want_sc)
    want = jscen.run_scenario(want_sc, seed=0)
    got = tscen.run_scenario(got_sc, seed=0, device="cpu")
    assert _as_dict(got) == _as_dict(want)
    # every guarantee the scenario is about holds
    for key in ("values_match", "survived", "corruption_detected", "honest_degradation",
                "wire_matches_plan", "survivors_match_plan"):
        if key in got:
            assert got[key].value is True, key


def test_the_stock_sweep_is_the_reference_minus_its_trainer_scenarios():
    want = [sc.name for sc in jscen.get_scenarios() if sc.kind != "trainer"]
    assert NAMES == want


def test_the_stock_sweep_is_the_reference_sweep():
    assert [(sc.name, sc.kind) for sc in tscen.get_scenarios()] == \
        [(sc.name, sc.kind) for sc in jscen.get_scenarios()]


def test_butterfly_scenario_refuses_coded_fault_kinds():
    sc = tscen.CollectiveScenario(name="x", p=4, variant="redundant",
                                  rounds=(tscen.ReduceRound(slow=(1,)),))
    with pytest.raises(ValueError, match="need scheme='coded'"):
        tscen.run_collective_scenario(sc, device="cpu")
