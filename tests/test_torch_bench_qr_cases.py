"""The port's ``general_qr``, ``dispatch`` and ``overlap`` bench cases against
the reference's on the CPU, at the smoke tier's kwargs (the blocked QR on
``use_pallas=True``: the reference's Pallas kernels in interpret mode, the
port's kernels' plain versions).

Metric names, gates, directions, units and tolerances are equal; hard ints
and bools equal, byte, sweep, round and dispatch counts exact
(``bench_parity``); timing metrics left out; the warn-gated errors of both
sides inside the case's own tolerances.  The cases' raw ``run`` numbers are
held too, with the port's bitwise contracts (pipeline ≡ eager, fused ≡
split, warm ≡ cold) asserted where the reference records them warn-gated.
The reference's outputs are computed once per module.
"""
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import repro.bench.cases.dispatch as jdispatch  # noqa: E402
import repro.bench.cases.general_qr as jgeneral  # noqa: E402
import repro.bench.cases.overlap as joverlap  # noqa: E402

import bench_parity as bp  # noqa: E402
from repro_torch.bench import registry  # noqa: E402
from repro_torch.bench.cases import dispatch, general_qr, overlap  # noqa: E402
from repro_torch.bench.registry import BenchFailure  # noqa: E402

NAMES = ("general_qr", "dispatch", "overlap")
JMODS = {"general_qr": jgeneral, "dispatch": jdispatch, "overlap": joverlap}
PMODS = {"general_qr": general_qr, "dispatch": dispatch, "overlap": overlap}


def _smoke(name):
    return registry.REGISTRY[name].kwargs("smoke")


def _case_of(mod, rows):
    """The case's metrics from already-measured ``run`` numbers (the case
    calls its module's ``run`` once)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "run", lambda **kw: dict(rows))
        return mod.case(**_kw_of(mod))


def _kw_of(mod):
    name = mod.__name__.rsplit(".", 1)[1]
    kw = _smoke(name)
    return kw if mod in JMODS.values() else dict(kw, device="cpu")


@pytest.fixture(scope="module")
def ref():
    rows = {name: JMODS[name].run(**_smoke(name)) for name in NAMES}
    return rows, {name: _case_of(JMODS[name], rows[name]) for name in NAMES}


@pytest.fixture(scope="module")
def port():
    rows = {name: PMODS[name].run(**_smoke(name), device="cpu") for name in NAMES}
    return rows, {name: _case_of(PMODS[name], rows[name]) for name in NAMES}


def test_smoke_kwargs_are_the_reference_registrys():
    from repro.bench.registry import REGISTRY as JREGISTRY

    for name in NAMES:
        for tier in ("smoke", "full"):
            assert registry.REGISTRY[name].kwargs(tier) == JREGISTRY[name].kwargs(tier)
        assert registry.REGISTRY[name].tags == JREGISTRY[name].tags
        assert registry.REGISTRY[name].fn is PMODS[name].case


@pytest.mark.parametrize("name", NAMES)
def test_case_metrics_equal_reference(name, ref, port):
    left = bp.assert_metrics_match(port[1][name], ref[1][name])
    for key, (g, w) in left.items():
        if key.endswith("_err"):
            bound = general_qr.R_TOL if name == "general_qr" else dispatch.BATCH_TOL
            assert 0 <= g <= bound and 0 <= w <= bound, key
        elif isinstance(w, bool):
            assert g is True, key          # the port holds its bitwise contracts
        else:
            assert g == w, key             # eager_kernel_dispatches


# the counts of each case's run, exact against the reference's
RUN_KEYS = {
    "general_qr": ("p", "m_local", "n", "panel_width", "n_panels", "trailing_sweeps",
                   "trailing_read_bytes", "trailing_write_bytes", "dispatches", "batch",
                   "batched_dispatches", "survivors"),
    "dispatch": ("n_panels", "traces_first", "traces_second", "dispatches_cold",
                 "dispatches_warm", "dispatches_half_width", "n_panels_half_width",
                 "dispatches_batched", "eager_kernel_dispatches", "allreduce_retrace",
                 "valid_identical"),
    "overlap": ("n_panels", "log2_p", "rounds_fused", "rounds_split", "rounds_fused_expected",
                "rounds_split_expected", "overlapped_fused", "overlapped_split",
                "wire_bytes_fused", "wire_bytes_split", "traces_first", "traces_second",
                "dispatches_fused", "dispatches_warm", "dispatches_split",
                "stacked_wire_exact", "valid_identical"),
}


@pytest.mark.parametrize("name", NAMES)
def test_run_numbers_equal_reference(name, ref, port):
    got, want = port[0][name], ref[0][name]
    assert set(got) == set(want)
    for key in RUN_KEYS[name]:
        assert got[key] == want[key], key


def test_general_qr_errors_and_survivors(ref, port):
    got, want = port[0]["general_qr"], ref[0]["general_qr"]
    for key in ("r_err", "recon_err", "batched_r_err"):
        assert got[key] <= general_qr.R_TOL and want[key] <= general_qr.R_TOL, key
    assert got["ortho_err"] <= 1e-4
    assert set(got["survivors"]) == set(general_qr.GUARANTEE_SPECS)
    assert all(s["match"] and s["survivors"] == s["expected"]
               for s in got["survivors"].values())
    assert got["trailing_sweeps"] == got["n_panels"] == 3


@pytest.mark.parametrize("key,bad", [("r_err", 1.0), ("recon_err", 1.0),
                                     ("trailing_sweeps", 2), ("dispatches", 2),
                                     ("batched_dispatches", 3), ("batched_r_err", 1.0)])
def test_general_qr_gates_raise(port, key, bad):
    with pytest.raises(BenchFailure):
        _case_of(general_qr, dict(port[0]["general_qr"], **{key: bad}))


def test_general_qr_survivor_gates_raise(port):
    rows = port[0]["general_qr"]
    for bad in ({"match": False}, {"survivors": 0}):
        survivors = dict(rows["survivors"], redundant=dict(rows["survivors"]["redundant"], **bad))
        with pytest.raises(BenchFailure):
            _case_of(general_qr, dict(rows, survivors=survivors))


def test_dispatch_holds_the_bitwise_contracts(port):
    rows = port[0]["dispatch"]
    dispatch.check(rows)
    assert rows["bit_identical_eager"] and rows["bit_identical_warm"]
    assert rows["valid_identical"] and rows["eager_rel_err"] == 0.0
    assert (rows["traces_first"], rows["traces_second"]) == (1, 0)
    assert rows["dispatches_cold"] == rows["dispatches_half_width"] == 1
    assert rows["n_panels_half_width"] == 2 * rows["n_panels"]
    assert rows["dispatches_batched"] == 1 and rows["allreduce_retrace"] == 0


@pytest.mark.parametrize("key,bad", [("eager_rel_err", 1.0), ("valid_identical", False),
                                     ("bit_identical_warm", False), ("traces_second", 1),
                                     ("dispatches_cold", 2), ("dispatches_half_width", 3),
                                     ("batch_rel_err", 1.0)])
def test_dispatch_check_raises_on_each_gate(port, key, bad):
    with pytest.raises(BenchFailure):
        dispatch.check(dict(port[0]["dispatch"], **{key: bad}))


def test_dispatch_cold_counts_do_not_depend_on_earlier_calls():
    kw = dict(p=2, m_local=32, n=24, panel_width=8, batch=2, repeats=1, device="cpu")
    first, second = dispatch.run(**kw), dispatch.run(**kw)
    assert (first["traces_first"], second["traces_first"]) == (1, 1)
    assert second["traces_second"] == 0


def test_overlap_holds_the_bitwise_contracts(port):
    got = port[0]["overlap"]
    assert got["bit_identical_eager"] and got["bit_identical_split"] and got["bit_identical_warm"]
    assert got["rounds_fused"] == got["n_panels"] * got["log2_p"]
    assert got["overlapped_fused"] == got["n_panels"] - 1


@pytest.mark.parametrize("key,bad", [("rounds_fused", 0), ("rounds_split", 0),
                                     ("wire_bytes_fused", 1), ("stacked_wire_exact", False),
                                     ("overlapped_fused", 0), ("overlapped_split", 1),
                                     ("eager_rel_err", 1.0), ("bit_identical_warm", False),
                                     ("traces_second", 1), ("dispatches_fused", 2)])
def test_overlap_gates_raise(port, key, bad):
    with pytest.raises(BenchFailure):
        _case_of(overlap, dict(port[0]["overlap"], **{key: bad}))


@pytest.mark.parametrize("p,b,n_trail", [(4, 32, 64), (8, 16, 16), (2, 8, 24)])
def test_overlap_stacked_wire_bytes_exact(p, b, n_trail):
    assert overlap._stacked_wire_exact(p, b, n_trail, torch.device("cpu"))


def test_dispatch_module_entry_point_parses_guard(monkeypatch):
    calls = []
    monkeypatch.setattr(dispatch, "guard", lambda device=None: calls.append(device) or 2)
    assert dispatch.main(["--guard", "--device", "cpu"]) == 1
    monkeypatch.setattr(dispatch, "guard", lambda device=None: calls.append(device) or 0)
    assert dispatch.main(["--guard", "--device", "cpu"]) == 0
    assert calls == ["cpu", "cpu"]


def test_bitwise_helper_sees_nan_payloads_and_none():
    x = torch.tensor([1.0, float("nan")])
    assert dispatch._bitwise(x, x.clone())
    assert not dispatch._bitwise(x, torch.tensor([1.0, 2.0]))
    assert dispatch._bitwise(None, None) and not dispatch._bitwise(x, None)
    assert dispatch._bitwise(torch.tensor([True, False]), torch.tensor([True, False]))
    assert not dispatch._bitwise(x, x.to(torch.float64))
