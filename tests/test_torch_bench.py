"""The port's bench harness (``repro_torch.bench``) against the JAX
package's on the CPU: the registry, the runner, the schema (which accepts
and rejects the same documents, the port spelling the framework version
``torch_version``), the comparator (the same failures, warnings and notes
on the same pair of documents), and the smoke tier of the ported cases,
whose non-timing metrics equal the reference's case functions'."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
from repro.bench import compare as jcompare  # noqa: E402
from repro.bench import runner as jrunner  # noqa: E402
from repro.bench import schema as jschema  # noqa: E402
from repro.bench.registry import SkipCase as JSkipCase  # noqa: E402
from repro.bench.registry import bench_case as jbench_case  # noqa: E402

from repro_torch.bench import compare, registry, runner, schema  # noqa: E402
from repro_torch.bench.registry import BenchFailure, SkipCase, bench_case, cases_for  # noqa: E402

# the reference's registry: the fourteen modules of repro.bench.cases,
# tsqr_local_qr (registered by tsqr_scaling) and fault_scenarios
PORTED = {"autotune", "coded", "comm_volume", "dispatch", "fault_scenarios", "general_qr",
          "kernels", "overlap", "powersgd", "robustness", "roofline", "semantics", "serving",
          "training", "tsqr_local_qr", "tsqr_scaling"}


def _as_reference(doc: dict) -> dict:
    """A port document spelled as the reference's: ``jax_version`` in place
    of ``torch_version``."""
    out = json.loads(json.dumps(doc))
    out["jax_version"] = out.pop("torch_version")
    return out


def _as_port(doc: dict) -> dict:
    out = json.loads(json.dumps(doc))
    out["torch_version"] = out.pop("jax_version")
    return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_list_names_exactly_the_ported_cases(capsys):
    from repro_torch.bench import cases  # noqa: F401 — registers
    from repro_torch.bench.__main__ import main

    from repro.bench import cases as jcases  # noqa: F401 — registers the reference's
    from repro.bench.registry import REGISTRY as JREGISTRY

    assert len(PORTED) == 16 and set(JREGISTRY) == PORTED
    assert set(registry.REGISTRY) == PORTED
    assert {c.name for c in cases_for("smoke")} == PORTED == {c.name for c in cases_for("full")}
    for name in PORTED:
        assert registry.REGISTRY[name].tiers == JREGISTRY[name].tiers, name
    assert main(["list"]) == 0
    listed = {line.split()[0] for line in capsys.readouterr().out.splitlines()}
    assert listed == PORTED


def test_registry_tier_filter_and_duplicates():
    table = {}
    bench_case("a", tiers=("smoke",), registry=table)(lambda: {"m": 1})
    bench_case("b", tiers=("full",), registry=table)(lambda: {"m": 1})
    assert [c.name for c in cases_for("smoke", registry=table)] == ["a"]
    assert [c.name for c in cases_for("full", registry=table)] == ["b"]
    with pytest.raises(ValueError, match="duplicate"):
        bench_case("a", registry=table)(lambda: {})
    with pytest.raises(KeyError, match="unknown bench case"):
        cases_for("smoke", only=("nope",), registry=table)
    with pytest.raises(ValueError, match="unknown tiers"):
        bench_case("c", tiers=("nightly",), registry=table)(lambda: {})


def test_scenarios_reexport_metric_and_failure():
    from repro_torch.bench import scenarios

    assert scenarios.Metric is schema.Metric and scenarios.BenchFailure is BenchFailure
    assert {"Metric", "BenchFailure"} <= set(scenarios.__all__)
    assert registry.REGISTRY["fault_scenarios"].fn is scenarios.case


# ---------------------------------------------------------------------------
# runner + schema
# ---------------------------------------------------------------------------

def _toy_registry(bench_case_fn, metric, skip=SkipCase):
    table = {}
    bench_case_fn("ok_case", registry=table, repeats=3, params={"smoke": {"x": 2}})(
        lambda x, **_: {"doubled": metric(2 * x, gate="hard", direction="higher"),
                        "info": 3.5})
    bench_case_fn("skippy", registry=table)(
        lambda **_: (_ for _ in ()).throw(skip("no artifacts")))
    return table


def _port_doc():
    return runner.run_cases("smoke", registry=_toy_registry(bench_case, schema.Metric),
                            verbose=False, device="cpu")


def test_runner_emits_valid_doc(tmp_path):
    doc = _port_doc()
    schema.validate(doc)
    assert doc["backend"] == "cpu" and doc["torch_version"] == torch.__version__
    assert doc["card"] is None and doc["n_devices"] == 1
    ok = doc["cases"]["ok_case"]
    assert ok["status"] == "ok" and ok["params"] == {"x": 2}
    assert ok["metrics"]["doubled"] == {"value": 4, "gate": "hard", "direction": "higher"}
    assert ok["metrics"]["info"]["gate"] == "warn"
    for t in ("time_mean_us", "time_p50_us", "time_p90_us", "time_min_us"):
        assert ok["metrics"][t]["gate"] == "warn" and ok["metrics"][t]["direction"] == "lower"
    assert doc["cases"]["skippy"] == {"params": {}, "status": "skipped",
                                      "skip_reason": "no artifacts"}
    path = runner.write_doc(doc, out_dir=str(tmp_path))
    assert path.startswith(str(tmp_path)) and "BENCH_" in path
    with open(path) as f:
        schema.validate(json.load(f))
    assert runner.DEFAULT_OUT_DIR == "results/bench_torch"
    # the same toy cases make the same document on the reference's side
    jdoc = jrunner.run_cases("smoke", registry=_toy_registry(jbench_case, jschema.Metric, JSkipCase),
                             verbose=False)
    strip = ("created", "git_sha", "backend", "platform", "python", "n_devices")
    port = _as_reference(doc)
    for d in (jdoc, port):
        for c in d["cases"].values():
            for k in [k for k in c.get("metrics", {}) if k.startswith("time_")]:
                del c["metrics"][k]
    want = {k: v for k, v in jdoc.items() if k not in strip + ("jax_version",)}
    got = {k: v for k, v in port.items() if k not in strip + ("jax_version", "card")}
    assert got == want


def test_runner_records_errors_and_bench_failures():
    table = {}
    bench_case("boom", registry=table)(
        lambda **_: (_ for _ in ()).throw(BenchFailure("guarantee broke")))
    bench_case("crash", registry=table)(lambda **_: 1 / 0)
    doc = runner.run_cases("smoke", registry=table, verbose=False, device="cpu")
    assert doc["cases"]["boom"]["status"] == "error"
    assert "invariant violated: guarantee broke" == doc["cases"]["boom"]["error"]
    assert doc["cases"]["crash"] == {"params": {}, "status": "error",
                                     "error": "ZeroDivisionError: division by zero"}


def _mutations():
    def m(fn, name):
        fn.__name__ = name
        return fn

    return [
        m(lambda d: d.update(schema_version=99), "stale"),
        m(lambda d: d["cases"]["ok_case"]["metrics"]["doubled"].update(gate="soft"), "gate"),
        m(lambda d: d["cases"]["ok_case"]["metrics"]["doubled"].update(direction="up"), "dir"),
        m(lambda d: d["cases"]["ok_case"]["metrics"]["doubled"].update(value="4"), "value"),
        m(lambda d: d["cases"]["ok_case"]["metrics"]["doubled"].update(tolerance=-1), "tol"),
        m(lambda d: d["cases"]["ok_case"]["metrics"]["doubled"].update(extra=1), "extra"),
        m(lambda d: d["cases"]["ok_case"].update(status="meh"), "status"),
        m(lambda d: d["cases"]["ok_case"].update(metrics={}), "no_metrics"),
        m(lambda d: d["cases"]["skippy"].update(skip_reason=""), "no_reason"),
        m(lambda d: d["cases"].clear(), "no_cases"),
        m(lambda d: d.update(n_devices="eight"), "n_devices"),
        m(lambda d: d.update(n_devices=0), "zero_devices"),
        m(lambda d: d.update(tier=""), "tier"),
        m(lambda d: d.update(git_sha=7), "git_sha"),
        m(lambda d: d.update(created=None), "created"),
        m(lambda d: d.update(platform="anything"), "valid_platform"),
        m(lambda d: d.update(git_sha="abc1234"), "valid_sha"),
    ]


@pytest.mark.parametrize("mutate", _mutations(), ids=lambda f: f.__name__)
def test_schema_accepts_and_rejects_what_reference_does(mutate):
    doc = _port_doc()
    jdoc = _as_reference(doc)
    jschema.validate(jdoc)
    bad, jbad = json.loads(json.dumps(doc)), json.loads(json.dumps(jdoc))
    mutate(bad)
    mutate(jbad)

    def verdict(validate, d):
        try:
            validate(d)
        except ValueError as e:
            return str(e).split(":")[0]
        return "ok"

    got, want = verdict(schema.validate, bad), verdict(jschema.validate, jbad)
    assert got == want
    missing = json.loads(json.dumps(doc))
    del missing["torch_version"]
    with pytest.raises(schema.SchemaError, match="torch_version"):
        schema.validate(missing)


# ---------------------------------------------------------------------------
# comparator
# ---------------------------------------------------------------------------

def _docs(mod_schema, metrics, status="ok", case="c", tier="smoke", params=None,
          version="0.4.37"):
    entry = {"status": status, "params": params or {}}
    if status == "ok":
        entry["metrics"] = {k: mod_schema.metric_to_json(mod_schema.Metric(*m[0], **m[1]))
                            for k, m in metrics.items()}
    elif status == "skipped":
        entry["skip_reason"] = "n/a"
    return {
        "schema_version": mod_schema.SCHEMA_VERSION, "created": "2026-07-27T00:00:00Z",
        "git_sha": None, "jax_version": version, "backend": "cpu", "platform": "test",
        "python": "3.10", "n_devices": 1, "tier": tier, "cases": {case: entry},
    }


def M(value, **kw):  # noqa: N802 — a metric spec both sides build
    return ((value,), dict({"gate": "hard", "direction": "exact"}, **kw))


PAIRS = {
    "hard_higher_regressed": ({"s": M(12, direction="higher")}, {"s": M(8, direction="higher")}),
    "hard_higher_improved": ({"s": M(12, direction="higher")}, {"s": M(16, direction="higher")}),
    "exact_same": ({"m": M(64), "h": M(True)}, {"m": M(64), "h": M(True)}),
    "exact_drift": ({"m": M(64), "h": M(True)}, {"m": M(65), "h": M(True)}),
    "bool_flipped": ({"h": M(True)}, {"h": M(False)}),
    "float_exact": ({"e": M(0.5)}, {"e": M(0.52)}),
    "timing_slow": ({"t": M(100.0, gate="warn", direction="lower")},
                    {"t": M(1000.0, gate="warn", direction="lower")}),
    "timing_near": ({"t": M(100.0, gate="warn", direction="lower")},
                    {"t": M(120.0, gate="warn", direction="lower")}),
    "tolerance_within": ({"e": M(0.10, direction="lower", tolerance=0.5)},
                         {"e": M(0.14, direction="lower", tolerance=0.5)}),
    "tolerance_beyond": ({"e": M(0.10, direction="lower", tolerance=0.5)},
                         {"e": M(0.16, direction="lower", tolerance=0.5)}),
    "metric_gone": ({"m": M(1)}, {"other": M(1)}),
    "warn_metric_gone": ({"t": M(1.0, gate="warn")}, {"m": M(1)}),
    "nan": ({"e": M(0.1, direction="lower")}, {"e": M(float("nan"), direction="lower")}),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("strict", [False, True])
def test_compare_docs_equals_reference(name, strict):
    old, new = PAIRS[name]
    jold, jnew = _docs(jschema, old), _docs(jschema, new)
    got = compare.compare_docs(_as_port(jold), _as_port(jnew))
    want = jcompare.compare_docs(jold, jnew)
    assert (got.failures, got.warnings, got.notes) == (want.failures, want.warnings, want.notes)
    assert got.exit_code(strict_timing=strict) == want.exit_code(strict_timing=strict)
    assert got.report() == want.report()


@pytest.mark.parametrize("case", ["case_gone", "ok_to_skipped", "skipped_both",
                                  "skipped_to_ok", "tier", "params", "new_case", "version"])
def test_compare_coverage_and_mismatches_equal_reference(case):
    one = {"m": M(1)}
    old, new = {
        "case_gone": (_docs(jschema, one), _docs(jschema, one, case="other")),
        "ok_to_skipped": (_docs(jschema, one), _docs(jschema, {}, status="skipped")),
        "skipped_both": (_docs(jschema, {}, status="skipped"),
                         _docs(jschema, {}, status="skipped")),
        "skipped_to_ok": (_docs(jschema, {}, status="skipped"), _docs(jschema, one)),
        "tier": (_docs(jschema, one), _docs(jschema, one, tier="full")),
        "params": (_docs(jschema, one), _docs(jschema, one, params={"trials": 9})),
        "new_case": (_docs(jschema, one), _docs(jschema, one) | {"cases": {
            **_docs(jschema, one)["cases"], **_docs(jschema, one, case="d")["cases"]}}),
        "version": (_docs(jschema, one), _docs(jschema, one, version="0.5.0")),
    }[case]
    got = compare.compare_docs(_as_port(old), _as_port(new))
    want = jcompare.compare_docs(old, new)
    notes = [n.replace("jax ", "torch ", 1) for n in want.notes]
    assert (got.failures, got.warnings, got.notes) == (want.failures, want.warnings, notes)
    assert got.exit_code() == want.exit_code()


def test_compare_cli_roundtrip(tmp_path):
    from repro_torch.bench.__main__ import main

    old = _as_port(_docs(jschema, {"m": M(10, direction="higher")}))
    bad = _as_port(_docs(jschema, {"m": M(1, direction="higher")}))
    po, pb = tmp_path / "old.json", tmp_path / "bad.json"
    po.write_text(json.dumps(old))
    pb.write_text(json.dumps(bad))
    assert main(["compare", str(po), str(po)]) == 0
    assert main(["compare", str(po), str(pb)]) == 1
    assert main(["compare", str(po), str(pb), "--tolerance", "0.95"]) == 0


# ---------------------------------------------------------------------------
# the ported cases at the smoke tier against the reference's case functions
# ---------------------------------------------------------------------------

def _untimed(metrics: dict) -> dict:
    return {k: m for k, m in metrics.items() if m.gate == "hard"}


def _smoke(name: str) -> dict:
    from repro_torch.bench import cases  # noqa: F401

    return registry.REGISTRY[name].kwargs("smoke")


@pytest.mark.parametrize("name", ["semantics", "robustness", "comm_volume", "coded", "kernels"])
def test_smoke_case_metrics_equal_reference(name):
    import importlib

    kwargs = _smoke(name)
    jmod = importlib.import_module(f"repro.bench.cases.{name}")
    want = jmod.case(**kwargs)
    got = registry.REGISTRY[name].fn(**kwargs, device="cpu")
    assert set(got) == set(want)
    for key, m in want.items():
        g = got[key]
        assert (g.gate, g.direction, g.unit, g.tolerance) == (m.gate, m.direction, m.unit,
                                                            m.tolerance), key
        if m.gate == "hard":
            assert isinstance(g.value, bool) == isinstance(m.value, bool), key
            if isinstance(m.value, (bool, int, np.integer)):
                assert g.value == m.value, key
            else:
                assert g.value == pytest.approx(m.value, rel=1e-12), key
        elif key in ("death_err", "corrupt_err"):
            # decoded R against the fault-free R, relative to max|R|: both
            # sides sit far inside reconstruction_tol
            assert g.value <= 1e-4 and m.value <= 1e-4, key
    assert _untimed(got)


def test_kernels_case_sweeps_and_bytes_exact():
    from repro_torch.bench.cases import kernels

    rows = kernels.run(m=2048, n=32, iters=1, device="cpu")
    assert (rows["fused"]["tall_sweeps"], rows["unfused"]["tall_sweeps"]) == (2, 4)
    assert rows["fused"]["read_bytes"] == 2 * 2048 * 32 * 4 + 32 * 32 * 4
    assert rows["r_consistent"] and rows["r_rel_dev"] <= 1e-5
    assert rows["fused_total_bytes"] < rows["unfused_total_bytes"]


def test_tsqr_cases_run_every_local_r_spelling():
    got = registry.REGISTRY["tsqr_local_qr"].fn(p=4, m_loc=64, n=8, iters=1, device="cpu")
    assert set(got) == {"us_jnp", "us_cqr2", "us_cqr2_pallas"}
    got = registry.REGISTRY["tsqr_scaling"].fn(ps=(4,), m_loc=32, n=4, iters=1, device="cpu")
    assert set(got) == {"us_tree_P4", "us_redundant_P4", "redundant_overhead_P4"}
    assert all(m.gate == "warn" for m in got.values())


def test_autotune_case_gates_and_clears(tmp_path):
    from repro_torch.bench.cases import autotune as case_mod
    from repro_torch.kernels import autotune as at

    rows = case_mod.run(m=256, n=32, reps=1, out_dir=str(tmp_path), device="cpu")
    assert rows["winners_legal"] and rows["winners_reproducible"]
    assert rows["n_entries"] == 4 and (tmp_path / "plain.json").exists()
    case_mod.check_accounting(rows["accounting"])
    assert not at.installed() and at.machine_constants() is None
    acc = rows["accounting"]["gram"]
    with pytest.raises(BenchFailure, match="predicted read_bytes"):
        case_mod.check_accounting({"gram": dict(acc, observed_read_bytes=0)})
    with pytest.raises(BenchFailure, match="new traces"):
        case_mod.check_accounting({"gram": dict(acc, warm_traces=1)})
