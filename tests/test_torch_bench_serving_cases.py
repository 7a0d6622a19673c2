"""The port's ``serving``, ``powersgd`` and ``roofline`` bench cases against the
reference's on the CPU, at the smoke tier's kwargs, and the port's retrace
guard (``dispatch.guard``).

Metric names, gates, directions, units and tolerances are equal
(``bench_parity``), hard ints and bools equal, timing metrics left out.
``powersgd``: each ``rel_error_r*`` within the metric's own tolerance
(0.10) of the reference's with the port's own start basis (a
``torch.Generator`` cannot draw ``jax.random``'s bits), and within
``BASIS_RTOL`` once the reference's basis is handed across
(``state_from_reference``).  ``roofline``: the ``cqr2_speedup_r_*`` ratios
equal, the ``_hbm_s_`` times in the ratio of the two data-sheet bandwidths
(the reference prices a TPU v5e's 819e9 B/s, the port an H100's 3.35e12).
The guard returns 0 and prints the reference's 18 lines (its four mesh
checks on a mesh of this process alone); run inside a world of four CPU
ranks it prints the 19th, the reference's ``ShardMapComm`` line, from rank
0.  The reference's 26 s guard is not run here, its lines are the literal
list below.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax  # noqa: E402
import repro.bench.cases.powersgd as jpowersgd  # noqa: E402
import repro.bench.cases.roofline as jroofline  # noqa: E402
import repro.bench.cases.serving as jserving  # noqa: E402
from repro.optim import powersgd as jpsgd  # noqa: E402

import bench_parity as bp  # noqa: E402
from repro_torch.bench import registry  # noqa: E402
from repro_torch.bench.cases import dispatch, powersgd, roofline, serving  # noqa: E402
from repro_torch.bench.registry import BenchFailure  # noqa: E402
from repro_torch.kernels import dispatch as tdispatch  # noqa: E402
from repro_torch.optim import powersgd as tpsgd  # noqa: E402
from repro_torch.optim import state_from_reference  # noqa: E402

NAMES = ("serving", "powersgd", "roofline")
JMODS = {"serving": jserving, "powersgd": jpowersgd, "roofline": jroofline}
PMODS = {"serving": serving, "powersgd": powersgd, "roofline": roofline}

# rel_error of a PowerSGD round from the same start basis: both sides run
# f32 products and the butterfly's QR in their own orders
BASIS_RTOL = 1e-5

# The reference's guard prints these 18 lines on one device
# (src/repro/bench/cases/dispatch.py:246-438); the ShardMapComm line comes
# only with 4 or more devices.
REFERENCE_GUARD = (
    ["blocked_qr_pipeline"] * 4
    + ["blocked_qr_pipeline"] * 2          # blocked_qr_shard_map, fuse auto and off
    + ["tsqr_shard_map", "tsqr_gram_shard_map", "ft_allreduce", "tsqr_coded",
       "tsqr_coded", "kernel:trailing_update", "serving:warm_stream",
       "train_step:powersgd", "train_step:orthosgd", "tuned:kernel:gram",
       "tuned:blocked_qr_pipeline", "tuned:blocked_qr_pipeline"]
)
MESH_LINES = (4, 5, 6, 7)     # the two blocked_qr_shard_map checks, tsqr_(gram_)shard_map
SHARD_MAP_LINE = 12           # where the ShardMapComm ft_allreduce line joins


def _smoke(name):
    return registry.REGISTRY[name].kwargs("smoke")


@pytest.fixture(scope="module")
def ref():
    return {name: JMODS[name].case(**_smoke(name)) for name in NAMES}


@pytest.fixture(scope="module")
def port():
    return {name: registry.REGISTRY[name].fn(**_smoke(name), device="cpu") for name in NAMES}


def test_registrations_are_the_reference_registrys():
    from repro.bench.registry import REGISTRY as JREGISTRY

    for name in NAMES:
        for tier in ("smoke", "full"):
            assert registry.REGISTRY[name].kwargs(tier) == JREGISTRY[name].kwargs(tier)
        assert registry.REGISTRY[name].tags == JREGISTRY[name].tags
        assert registry.REGISTRY[name].fn is PMODS[name].case


def test_serving_metrics_equal_reference(ref, port):
    left = bp.assert_metrics_match(port["serving"], ref["serving"])
    assert set(left) == {"max_rel_err", "prewarm_traces"}
    g, w = left["max_rel_err"]
    assert g <= 1e-3 and w <= 1e-3
    g, w = left["prewarm_traces"]
    assert g == w


def test_serving_run_numbers_equal_reference():
    kw = dict(p=4, n_requests=8, fault_period=2, max_batch_cap=2)
    want = jserving.run(**kw)
    got = serving.run(**kw, device="cpu")
    assert set(got) == set(want)
    for key in ("responses", "prewarm_traces", "warm_traces", "drains", "faulted_drains",
                "reserved", "filler_slots", "dispatches_per_drain_max",
                "dispatches_per_drain_min", "requests_per_bucket", "reserve_bitwise",
                "planner"):
        assert got[key] == want[key], key
    assert got["max_rel_err"] <= 1e-3


@pytest.mark.parametrize("key,bad", [("responses", 23), ("warm_traces", 1),
                                     ("dispatches_per_drain_max", 2), ("faulted_drains", 0),
                                     ("reserve_bitwise", False), ("max_rel_err", 1.0)])
def test_serving_gates_raise(key, bad):
    rows = {"n_requests": 24, "responses": 24, "warm_traces": 0,
            "dispatches_per_drain_max": 1, "dispatches_per_drain_min": 1,
            "faulted_drains": 1, "reserved": 1, "reserve_bitwise": True, "max_rel_err": 0.0}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serving, "run", lambda **kw: dict(rows, **{key: bad}))
        with pytest.raises(BenchFailure):
            serving.case(device="cpu")


def test_powersgd_metrics_within_the_metrics_tolerance(ref, port):
    left = bp.assert_metrics_match(port["powersgd"], ref["powersgd"],
                                   custom={k for k in ref["powersgd"] if k.startswith("rel_")})
    assert {k for k in left} == {f"rel_error_r{r}" for r in _smoke("powersgd")["ranks"]}
    for key, (g, w) in left.items():
        tol = ref["powersgd"][key].tolerance
        assert abs(g - w) <= tol * w, (key, g, w)


def test_powersgd_from_the_reference_basis(monkeypatch):
    """The reference's start basis handed to the port: the same rounds."""
    kw = dict(ranks=(2, 8), p_model=4, m_loc=64, n=128, spectrum=64, iters=1)

    def reference_basis(generator, shape, cfg, leading=(), *, device=None):
        del generator
        ref_cfg = jpsgd.PowerSGDConfig(rank=cfg.rank, error_feedback=cfg.error_feedback)
        return state_from_reference(
            jpsgd.init_state(jax.random.key(0), shape, ref_cfg, leading=leading), device)

    want = jpowersgd.run(**kw)
    monkeypatch.setattr(tpsgd, "init_state", reference_basis)
    got = powersgd.run(**kw, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("rank", "bytes_dense", "bytes_compressed", "compression_x"):
            assert g[key] == w[key], key
        assert g["rel_error"] == pytest.approx(w["rel_error"], rel=BASIS_RTOL)


def test_powersgd_basis_comes_from_a_seeded_generator():
    kw = dict(ranks=(4,), p_model=2, m_loc=32, n=64, spectrum=32, iters=1, device="cpu")
    first, second = powersgd.run(**kw), powersgd.run(**kw)
    assert first[0]["rel_error"] == second[0]["rel_error"]


def test_roofline_metrics_equal_reference_and_rescale_the_bandwidth(ref, port):
    left = bp.assert_metrics_match(port["roofline"], ref["roofline"])
    assert port["roofline"]["n_cells"].value == ref["roofline"]["n_cells"].value == 0
    speedups = [k for k in port["roofline"] if k.startswith("cqr2_speedup_r_")]
    assert len(speedups) == len(jroofline.CQR2_SHAPES)
    for key in speedups:
        assert port["roofline"][key].value == ref["roofline"][key].value
    hbm = {k for k in left if "_hbm_s_" in k}
    assert hbm == set(left) - {"n_cells"} and len(hbm) == 2 * len(jroofline.CQR2_SHAPES)
    for key in hbm:
        g, w = left[key]
        assert g / w == pytest.approx(jroofline.HBM_BW / roofline.HBM_BW, rel=1e-12), key


def test_roofline_rows_bytes_equal_reference():
    shapes = ((1 << 12, 32), (1 << 14, 64))
    want = jroofline.cqr2_rows(shapes=shapes, dtype="float32")
    got = roofline.cqr2_rows(shapes=shapes, dtype="float32", device="cpu")
    for g, w in zip(got, want):
        for key in ("m", "n", "unfused_bytes", "fused_q_bytes", "fused_r_bytes", "speedup_r",
                    "speedup_q"):
            assert g[key] == w[key], key
        # the R-only pipeline streams the tall operand twice and writes none
        assert 2 * g["m"] * g["n"] * 4 <= g["fused_r_bytes"] < 3 * g["m"] * g["n"] * 4


def test_roofline_main_writes_the_port_report_only(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    roofline.main(device="cpu")
    assert (tmp_path / "results" / "bench_torch" / "roofline.md").is_file()
    assert not (tmp_path / "results" / "roofline.md").exists()
    text = (tmp_path / "results" / "bench_torch" / "roofline.md").read_text()
    assert text.count("\n") == 2 + len(roofline.CQR2_SHAPES)


def test_roofline_has_no_tpu_constant():
    from pathlib import Path

    src = Path(roofline.__file__).read_text()
    for const in ("197e12", "819e9", "50e9"):
        assert const not in src


def test_guard_prints_the_reference_lines_less_the_mesh_lines(capsys):
    """All 18 lines now, the mesh lines included (the name stays)."""
    assert dispatch.guard(device="cpu") == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[retrace-guard]")]
    assert len(REFERENCE_GUARD) == 18
    assert [REFERENCE_GUARD[i] for i in MESH_LINES] == [
        "blocked_qr_pipeline", "blocked_qr_pipeline", "tsqr_shard_map", "tsqr_gram_shard_map"]
    assert lines == [f"[retrace-guard] {name}: ok" for name in REFERENCE_GUARD]


def test_guard_in_a_four_rank_world_adds_the_shard_map_line(tmp_path):
    """Every rank runs the guard, ranks 0-3 the ``ShardMapComm`` check over
    their (1, 32) rows, and rank 0 alone prints: the reference's 18 lines
    with its ``ft_allreduce`` ``ShardMapComm`` line where the reference
    appends it, after ``kernel:trailing_update``."""
    from repro_torch.collective.dist import run_ranks

    import dist_parity

    results = run_ranks(dist_parity.guard_in_world, 4, device="cpu", rendezvous_dir=tmp_path)
    assert [failures for failures, _ in results] == [0, 0, 0, 0]
    want = list(REFERENCE_GUARD)
    want.insert(SHARD_MAP_LINE, "ft_allreduce")
    assert want[SHARD_MAP_LINE - 1] == "kernel:trailing_update"
    lines = [ln for ln in results[0][1].splitlines() if ln.startswith("[retrace-guard]")]
    assert lines == [f"[retrace-guard] {name}: ok" for name in want]
    assert all(text == "" for _, text in results[1:])


def test_guard_counts_a_retrace(capsys):
    def retraces():
        tdispatch.note_trace("guard_probe")

    assert dispatch._guarded("guard_probe", retraces) == 1
    assert dispatch._guarded("guard_probe", lambda: None) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["[retrace-guard] guard_probe: RETRACED x1", "[retrace-guard] guard_probe: ok"]


def test_powersgd_psum_model_sums_the_rank_axis():
    x = torch.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(powersgd._psum_model(x).numpy(), [[6, 9]] * 3)
