"""The port's ``training`` bench case on the CPU at ``archs=("mamba2-2.7b",),
parity_steps=2``.

The reference's case needs 4 devices (its bench CLI forces 8 host devices,
88 s here), so it is not run; its hard values are fixed by its own gates and
its scenarios' ``expect`` (``src/repro/bench/cases/training.py:150-270``),
and those are what the port's metrics are held to.  The port's replicas live
on one device, so its case never skips.  The case's helpers are tested one
by one, and the case as a whole once.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import repro.bench.cases.training as jtraining  # noqa: E402

from repro_torch.bench import registry  # noqa: E402
from repro_torch.bench.cases import training  # noqa: E402
from repro_torch.bench.registry import BenchFailure  # noqa: E402

ARCHS = ("mamba2-2.7b",)
SCENARIOS = {
    "mamba2_elastic": {"failures": 1, "shrinks": 1, "rejoins": 1},
    "mamba2_cascading": {"failures": 2, "recoveries": 2, "masked_steps": 4},
    "mamba2_blank_repeat": {"failures": 2, "recoveries": 2, "masked_steps": 4},
}


@pytest.fixture(scope="module")
def metrics():
    return training.case(archs=ARCHS, parity_steps=2, device="cpu")


def test_constants_and_registration_are_the_reference_s():
    from repro.bench.registry import REGISTRY as JREGISTRY

    assert training.PARITY_TOL == jtraining.PARITY_TOL
    assert training._DATA_WIDTH == jtraining._DATA_WIDTH
    for tier in ("smoke", "full"):
        assert registry.REGISTRY["training"].kwargs(tier) == JREGISTRY["training"].kwargs(tier)
    assert registry.REGISTRY["training"].tags == JREGISTRY["training"].tags


def test_case_metric_names_and_gates(metrics):
    want = {f"{opt}.{k}" for opt in ("powersgd", "orthosgd")
            for k in ("warm_trace_delta", "warm_dispatches", "loss_parity_ok",
                      "loss_parity_rel")}
    want |= {"elastic.traces_across_elastic", "elastic.post_rebuild_trace_delta",
             "elastic.mesh_classes_compiled", "elastic.loss_finite", "elastic.steps_per_sec"}
    for name, expect in SCENARIOS.items():
        want |= {f"{name}.{k}" for k in ("completed_final_step", "loss_finite",
                                         "final_replicas")}
        want |= {f"{name}.stat_{k}" for k in expect}
    assert set(metrics) == want
    warn = {"powersgd.loss_parity_rel", "orthosgd.loss_parity_rel", "elastic.steps_per_sec"}
    for key, m in metrics.items():
        assert m.gate == ("warn" if key in warn else "hard"), key
    assert metrics["elastic.steps_per_sec"].unit == "steps/s"
    assert metrics["elastic.steps_per_sec"].direction == "higher"


def test_case_hard_values_are_what_the_reference_gates_fix(metrics):
    for opt in ("powersgd", "orthosgd"):
        assert metrics[f"{opt}.warm_trace_delta"].value == 0
        assert metrics[f"{opt}.warm_dispatches"].value == 1
        assert metrics[f"{opt}.loss_parity_ok"].value is True
        assert 0 <= metrics[f"{opt}.loss_parity_rel"].value <= training.PARITY_TOL
    assert metrics["elastic.traces_across_elastic"].value == 2
    assert metrics["elastic.post_rebuild_trace_delta"].value == 0
    assert metrics["elastic.mesh_classes_compiled"].value == 2
    assert metrics["elastic.loss_finite"].value is True


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_zoo_scenarios_meet_their_expectations(metrics, name):
    for stat, want in SCENARIOS[name].items():
        assert metrics[f"{name}.stat_{stat}"].value == want
    assert metrics[f"{name}.completed_final_step"].value == 7
    assert metrics[f"{name}.loss_finite"].value is True
    assert metrics[f"{name}.final_replicas"].value == training._DATA_WIDTH


@pytest.mark.parametrize("opt", ["powersgd", "orthosgd"])
def test_one_dispatch_warm_step(opt):
    w = training._one_dispatch_warm(opt, "cpu")
    assert (w["trace_delta"], w["dispatches"], w["total_dispatches"]) == (0, 1, 1)
    assert math.isfinite(w["loss"])


def test_loss_parity_of_the_dense_baseline():
    pr = training._loss_parity("powersgd", 2, "cpu")
    assert pr["rel"] <= training.PARITY_TOL
    assert math.isfinite(pr["final_ft"]) and math.isfinite(pr["final_base"])


def test_elastic_round_trip_builds_one_step_per_mesh_class():
    el = training._elastic_zero_retrace("powersgd", "cpu")
    assert el["traces_across_elastic"] == 2 and el["step_cache_entries"] == 2
    assert el["post_rebuild_trace_delta"] == 0 and el["post_rebuild_dispatches"] == 1
    assert {k: el["fault_stats"][k] for k in ("failures", "shrinks", "rejoins")} == {
        "failures": 1, "shrinks": 1, "rejoins": 1}
    assert el["loss_finite"] and el["steps_per_sec"] > 0


def test_case_raises_when_a_warm_step_retraces(monkeypatch):
    monkeypatch.setattr(training, "_one_dispatch_warm",
                        lambda opt, device=None: {"trace_delta": 1, "dispatches": 1,
                                                  "total_dispatches": 1, "loss": 0.0})
    with pytest.raises(BenchFailure, match="warm train step"):
        training.case(archs=(), device="cpu")


def test_case_raises_past_the_parity_tolerance(monkeypatch):
    monkeypatch.setattr(training, "_one_dispatch_warm",
                        lambda opt, device=None: {"trace_delta": 0, "dispatches": 1,
                                                  "total_dispatches": 1, "loss": 0.0})
    monkeypatch.setattr(training, "_loss_parity",
                        lambda opt, steps, device=None: {"final_ft": 1.0, "final_base": 2.0,
                                                         "rel": 0.5})
    with pytest.raises(BenchFailure, match="dense baseline"):
        training.case(archs=(), device="cpu")
