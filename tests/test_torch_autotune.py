"""The port's autotuner (``repro_torch.kernels.autotune``) against the JAX
package's on the CPU: keys, shape classes and committed traffic equal the
reference's; winner re-selection and schema validation agree on the same
documents; the persisted table round-trips; resolution precedence, the
shared splits and ``CostModel.tuned``; and installing one shape class's
winner retraces no other warm class, counted as the reference counts it.
Every test starts and ends with no table installed."""
import dataclasses
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from repro.kernels import autotune as jat  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.qr import QRConfig as JQRConfig  # noqa: E402
from repro.qr import factorize as jfactorize  # noqa: E402
from repro.serve.planner import CostModel as JCostModel  # noqa: E402

from repro_torch import replay  # noqa: E402
from repro_torch.kernels import _launch, dispatch, ops  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels.backend import resolve_backend  # noqa: E402
from repro_torch.qr import QRConfig, factorize  # noqa: E402
from repro_torch.serve.planner import CostModel  # noqa: E402

KERNELS = ("gram", "apply_right", "fused_apply_gram", "trailing_update")
SHAPES = [(1, 1), (48, 13), (256, 32), (600, 64), (1000, 128), (4096, 256), (1 << 17, 512)]
DTYPES = [("float32", jnp.float32), ("bfloat16", jnp.bfloat16)]
PLAIN = resolve_backend("cpu")
MACHINE = at.MachineModel(mem_bw_bytes_per_s=4e10, flops_per_s=2e11)


@pytest.fixture(autouse=True)
def _no_table_leaks():
    at.clear()
    jat.clear()
    yield
    at.clear()
    jat.clear()


def _fake_timer():
    """A scripted clock: every measured interval is exactly 1 s, so the
    winner is set by the deterministic tie-break (the smallest split)."""
    ticks = itertools.count()
    return lambda: float(next(ticks))


def _speeding_timer():
    """A scripted clock whose k-th measured interval is 1/(k + 1) s: the
    candidate measured last wins, on both sides, whatever their priors."""
    state = {"t": 0.0, "k": 0, "open": False}

    def clock():
        if state["open"]:
            state["t"] += 1.0 / (state["k"] + 1)
            state["k"] += 1
        state["open"] = not state["open"]
        return state["t"]

    return clock


def _tune(shapes, kernels=KERNELS, **kw):
    return at.tune(shapes, kernels, device="cpu", timer=_fake_timer(), reps=1,
                   machine=MACHINE, **kw)


def _as_reference(doc: dict) -> dict:
    """The port's table as the reference's schema spells it: backend
    ``interpret`` and no ``batch`` field."""
    out = json.loads(json.dumps(doc))
    out["backend"] = "interpret"
    entries = {}
    for e in out["entries"].values():
        e["backend"] = "interpret"
        del e["batch"]
        entries[jat.entry_key(e["kernel"], "interpret", e["dtype"], e["shape_class"])] = e
    out["entries"] = entries
    return out


# ---------------------------------------------------------------------------
# keys, classes and committed traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_keys_and_committed_traffic_equal_reference(kernel, dtype, jdtype, m, n):
    assert at.shape_class(m, n) == jat.shape_class(m, n)
    assert at.trailing_panel_width(n) == jat.trailing_panel_width(n)
    for kind in ("plain", "cuda"):
        assert at.entry_key(kernel, kind, dtype, at.shape_class(m, n)) == jat.entry_key(
            kernel, kind, jdtype, jat.shape_class(m, n))
    assert at.entry_key(kernel, "plain", getattr(torch, dtype), "c") == jat.entry_key(
        kernel, "plain", jdtype, "c")
    for want_q in (True, False):
        assert at.committed_traffic(kernel, m, n, dtype, want_q=want_q) == \
            jat.committed_traffic(kernel, m, n, jdtype, want_q=want_q)


def test_unknown_kernel_rejected_like_reference():
    for mod in (at, jat):
        with pytest.raises(mod.AutotuneError, match="unknown kernel"):
            mod.committed_traffic("nope", 8, 8, "float32")


# ---------------------------------------------------------------------------
# winner re-selection and schema validation on the same documents
# ---------------------------------------------------------------------------

CANDIDATE_SETS = [
    [(32, 1e-3), (64, 1e-3), (128, 1e-3)],                 # a three-way tie
    [(32, 3e-3), (64, 1e-3), (128, 1e-3)],                 # a tie past the first
    [(32, 2e-3), (64, None), (256, 1.5e-3), (1024, 1.5e-3)],
    [(96, 5e-4), (32, 5e-4), (64, 7e-4)],                  # unsorted, tie
    [(4096, 1e-6), (32, 2e-6)],
]


@pytest.mark.parametrize("cands", CANDIDATE_SETS, ids=range(len(CANDIDATE_SETS)))
def test_select_winner_equals_reference(cands):
    entry = {"kernel": "gram", "shape_class": "m4096xn32", "candidates": [
        {"block_rows": br, "predicted_s": 1.0, "accum_bytes": 0, "measured_s": t}
        for br, t in cands]}
    assert at.select_winner(entry) == jat.select_winner(entry)
    entry["candidates"] = [dict(c, measured_s=None) for c in entry["candidates"]]
    for mod in (at, jat):
        with pytest.raises(mod.AutotuneError, match="no measured candidates"):
            mod.select_winner(entry)


def _mutations():
    def stale(d):
        d["schema_version"] = 99

    def missing(d):
        del next(iter(d["entries"].values()))["block_rows"]

    def bad_key(d):
        k = next(iter(d["entries"]))
        d["entries"]["gram|x|float32|m1xn1"] = d["entries"].pop(k)

    def empty(d):
        next(iter(d["entries"].values()))["candidates"] = []

    def no_machine(d):
        d["machine"]["flops_per_s"] = 0

    def not_dict(d):
        d["entries"] = []

    return [stale, missing, bad_key, empty, no_machine, not_dict]


@pytest.mark.parametrize("mutate", _mutations(), ids=lambda f: f.__name__)
def test_validate_table_rejects_what_reference_rejects(mutate):
    doc = _tune([(256, 32)])
    jdoc = _as_reference(doc)
    at.validate_table(doc)
    jat.validate_table(jdoc)
    bad, jbad = json.loads(json.dumps(doc)), json.loads(json.dumps(jdoc))
    mutate(bad)
    mutate(jbad)
    with pytest.raises(at.AutotuneSchemaError):
        at.validate_table(bad)
    with pytest.raises(jat.AutotuneSchemaError):
        jat.validate_table(jbad)


def test_batch_field_is_required():
    doc = _tune([(256, 32)], ("gram",))
    del next(iter(doc["entries"].values()))["batch"]
    with pytest.raises(at.AutotuneSchemaError, match="batch"):
        at.validate_table(doc)


# ---------------------------------------------------------------------------
# the tuner on the CPU: round trip, shared splits, legality
# ---------------------------------------------------------------------------

def test_tune_persists_and_round_trips(tmp_path):
    doc = _tune([(256, 32), (600, 64)], out_dir=str(tmp_path), batch=3)
    path = tmp_path / "plain.json"
    reloaded = at.load_table(str(path))
    assert reloaded == json.loads(json.dumps(doc))
    assert len(reloaded["entries"]) == 8
    for e in reloaded["entries"].values():
        assert at.entry_legal(e) and at.select_winner(e) == e["block_rows"]
        assert e["batch"] == 3 and e["arch"] == "cpu" and e["backend"] == "plain"
        read, write, _ = at.committed_traffic(e["kernel"], e["m"], e["n"], "float32")
        assert (e["predicted_read_bytes"], e["predicted_write_bytes"]) == (3 * read, 3 * write)
    assert reloaded["machine"] == MACHINE.as_dict()
    assert at.installed() == reloaded["entries"]


def test_gram_pair_shares_one_split():
    doc = _tune([(1000, 128)], ("gram", "fused_apply_gram"))
    g = doc["entries"][at.entry_key("gram", "plain", "float32", "m1024xn128")]
    f = doc["entries"][at.entry_key("fused_apply_gram", "plain", "float32", "m1024xn128")]
    assert g["block_rows"] == f["block_rows"] == at.select_winner(f)
    assert [c["block_rows"] for c in g["candidates"]] == [c["block_rows"] for c in f["candidates"]]
    assert [c["measured_s"] for c in g["candidates"]] == [c["measured_s"] for c in f["candidates"]]
    # the untuned split is always among the measured candidates
    default = at.default_block_rows("gram", 1000, 128)
    assert any(c["block_rows"] == default and c["measured_s"] is not None
               for c in g["candidates"])


def test_apply_right_has_its_fixed_tile_only():
    doc = _tune([(4096, 256), (4096, 64), (4096, 32)], ("apply_right",))
    got = {e["n"]: [c["block_rows"] for c in e["candidates"]] for e in doc["entries"].values()}
    assert got == {256: [512], 64: [512], 32: [1024]}


def test_entry_legal_rejects_off_candidate_misaligned_and_over_budget():
    e = next(iter(_tune([(4096, 64)], ("trailing_update",))["entries"].values()))
    assert at.entry_legal(e)
    assert not at.entry_legal(dict(e, block_rows=48))
    c0 = dict(e["candidates"][0], block_rows=48)
    assert not at.entry_legal(dict(e, block_rows=48, candidates=[c0]))
    over = [dict(c, accum_bytes=e["accum_budget_bytes"] + 1) for c in e["candidates"]]
    assert not at.entry_legal(dict(e, candidates=over))
    assert not at.entry_legal(dict(e, gemm_width_floor=2))


def test_predict_prices_partials_on_the_card_only():
    cuda = dataclasses.replace(PLAIN, kind="cuda")
    small = at.predict("gram", 1 << 16, 128, "float32", block_rows=32, machine=MACHINE,
                       backend=cuda, batch=8)
    big = at.predict("gram", 1 << 16, 128, "float32", block_rows=8192, machine=MACHINE,
                     backend=cuda, batch=8)
    assert small.accum_bytes == 8 * 2048 * 128 * 128 * 4 > at.ACCUM_BUDGET_BYTES["cuda"]
    assert big.accum_bytes == 8 * 8 * 128 * 128 * 4 and big.grid_steps == 8
    assert small.streamed_bytes - big.streamed_bytes == 2 * (small.accum_bytes - big.accum_bytes)
    plain = at.predict("gram", 1 << 16, 128, "float32", block_rows=32, machine=MACHINE,
                       backend=PLAIN, batch=8)
    assert plain.accum_bytes == 0
    assert (plain.read_bytes, plain.write_bytes) == (8 * (1 << 16) * 128 * 4, 8 * 128 * 128 * 4)


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

def test_resolve_block_rows_precedence():
    args = (600, 64, "float32")
    assert at.resolve_block_rows("gram", *args, backend=PLAIN) is None   # untuned
    _tune([(600, 64)], ("gram", "fused_apply_gram", "trailing_update"))
    winner = at.lookup("gram", *args, backend=PLAIN)["block_rows"]
    assert at.resolve_block_rows("gram", *args, backend=PLAIN) == winner
    assert at.resolve_block_rows("gram", *args, explicit=256, backend=PLAIN) == 256
    with pytest.raises(ValueError, match="multiple of 32"):
        at.resolve_block_rows("gram", *args, explicit=100, backend=PLAIN)
    # a class with no entry keeps the kernel's own split
    assert at.resolve_block_rows("gram", 48, 64, "float32", backend=PLAIN) is None
    # the shared splits
    tu = at.lookup("trailing_update", *args, backend=PLAIN)["block_rows"]
    assert at.resolve_block_rows("fused_apply_gram", *args, backend=PLAIN) == winner
    for op in ("panel_cross", "pad_cross"):
        assert at.resolve_block_rows(op, *args, backend=PLAIN) == tu
    # the installed winner is clamped to m rounded up to 32
    entry = at.lookup("gram", *args, backend=PLAIN)
    doc = {"schema_version": at.SCHEMA_VERSION, "backend": "plain", "arch": "cpu",
           "machine": MACHINE.as_dict(),
           "entries": {at.entry_key("gram", "plain", "float32", "m1024xn64"):
                       dict(entry, block_rows=4096)}}
    at.install(doc)
    assert at.resolve_block_rows("gram", *args, backend=PLAIN) == 608
    at.clear()
    assert at.resolve_block_rows("gram", *args, backend=PLAIN) is None


def test_generation_and_machine_constants():
    g0 = at.generation()
    assert at.machine_constants() is None
    _tune([(256, 32)], ("gram",))
    assert at.generation() == g0 + 1
    assert at.machine_constants() == MACHINE.as_dict()
    at.clear()
    assert at.generation() == g0 + 2 and at.machine_constants() is None


def test_cost_model_tuned_follows_the_installed_table():
    assert CostModel.tuned() == CostModel()
    assert dataclasses.asdict(CostModel.tuned()) == dataclasses.asdict(JCostModel.tuned())
    doc = _tune([(256, 32)], ("gram",))
    got = CostModel.tuned()
    assert got.mem_bw_bytes_per_s == doc["machine"]["mem_bw_bytes_per_s"] == 4e10
    assert got.flops_per_s == 2e11
    assert CostModel.tuned(mem_bw_bytes_per_s=1.0).mem_bw_bytes_per_s == 1.0
    jat.install(_as_reference(doc))
    assert dataclasses.asdict(CostModel.tuned()) == dataclasses.asdict(JCostModel.tuned())


# ---------------------------------------------------------------------------
# row splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows_per_split", [None, 32, 64, 96, 1024, 1 << 20])
@pytest.mark.parametrize("batch,m,width", [(1, 1, 1), (8, 31, 32), (8, 33, 128), (3, 600, 64),
                                           (8, 1 << 17, 512), (1, 1 << 19, 128)])
def test_splits_cover_every_row_once(batch, m, width, rows_per_split):
    for rows, splits in (_launch.row_split(batch, m, width, rows_per_split),
                         _launch.cross_split(batch, m, rows_per_split)):
        assert rows % 32 == 0 and 1 <= splits <= _launch.MAX_SPLITS
        starts = [s * rows for s in range(splits)]
        assert all(start < m for start in starts)            # no empty split
        covered = sum(min(m, start + rows) - start for start in starts)
        assert covered == m                                  # every row once
        if rows_per_split is not None:
            assert rows == min(rows_per_split, -(-m // 32) * 32)


def test_explicit_split_is_checked():
    for bad in (0, -32, 48, 31, 32.0, True):
        with pytest.raises(ValueError, match="multiple of 32"):
            _launch.row_split(1, 100, 32, bad)
        with pytest.raises(ValueError, match="multiple of 32"):
            _launch.check_rows("gram", bad)
    with pytest.raises(ValueError, match="at most 65535"):
        _launch.cross_split(1, 32 * 65536, 32)
    # the kernel wrappers check before taking the plain route
    a = torch.zeros((64, 8))
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.gram(a, use_pallas=True, block_rows=40)


# ---------------------------------------------------------------------------
# the retrace contract, counted as the reference counts it
# ---------------------------------------------------------------------------

def _counted(jcall, tcall):
    with jdispatch.track_dispatch() as jd:
        jcall()
    with dispatch.track_dispatch() as td:
        tcall()
    return td.as_dict(), jd.as_dict()


def test_install_never_retraces_other_shape_classes(rng):
    """The reference's test on both sides: two warm classes, a table for
    one; the other notes no new trace, the tuned one one, then none."""
    import jax

    jax.clear_caches()
    dispatch._KERNEL_SIGNATURES.clear()
    small = rng.standard_normal((48, 13)).astype(np.float32)
    big = rng.standard_normal((600, 13)).astype(np.float32)

    def calls(mod, conv, x):
        return lambda: mod.gram(conv(x), use_pallas=True)

    for x in (small, big, small):
        _counted(calls(jops, jnp.asarray, x), calls(ops, torch.from_numpy, x))
    got, want = _counted(calls(jops, jnp.asarray, small), calls(ops, torch.from_numpy, small))
    assert got == want and not got["traces"]

    # each side's last-measured candidate wins: not its untuned split
    at.tune([(600, 13)], ("gram",), device="cpu", timer=_speeding_timer(), reps=1,
            machine=MACHINE)
    jat.tune([(600, 13)], ("gram",), timer=_speeding_timer(), reps=1, out_dir=None)
    assert at.resolve_block_rows("gram", 600, 13, "float32", backend=PLAIN) == 128
    assert jat.resolve_block_rows("gram", 600, 13, jnp.float32) == 32   # not its 600
    for x, traces in ((small, {}), (big, {"kernel:gram": 1}), (big, {})):
        got, want = _counted(calls(jops, jnp.asarray, x), calls(ops, torch.from_numpy, x))
        assert got == want and got["traces"] == traces
    got = ops.gram(torch.from_numpy(big), use_pallas=True)
    np.testing.assert_allclose(got.numpy(), big.T.astype(np.float64) @ big, rtol=5e-4,
                               atol=5e-4)


def test_tuned_blocked_pipeline_counts_equal_reference(rng):
    """Installing a ``trailing_update`` entry re-keys the blocked pipeline of
    that geometry (one new program and its sweeps' traces on both sides)
    and leaves another geometry's warm program alone."""
    import jax

    jax.clear_caches()
    replay.clear()
    dispatch._KERNEL_SIGNATURES.clear()
    a = rng.standard_normal((4, 40, 12)).astype(np.float32)
    other = rng.standard_normal((4, 24, 12)).astype(np.float32)

    def both(x):
        return _counted(lambda: jfactorize(jnp.asarray(x), JQRConfig(panel_width=4,
                                                                     use_pallas=True)),
                        lambda: factorize(x, QRConfig(panel_width=4, use_pallas=True),
                                          device="cpu"))

    for x in (a, other):
        got, want = both(x)
        assert got == want and got["traces"]
    _tune([(40, 12)], ("trailing_update",))
    jat.tune([(40, 12)], ("trailing_update",), timer=_fake_timer(), reps=1, measure_top=1,
             out_dir=None)
    got, want = both(other)
    assert got == want and not got["traces"]
    got, want = both(a)
    assert got == want and got["traces"]["blocked_qr_pipeline"] == 1
    got, want = both(a)
    assert got == want and not got["traces"]


# ---------------------------------------------------------------------------
# QRConfig(block_rows=...) and installed winners reach the kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def seen_splits(monkeypatch):
    """Record the ``block_rows`` each blocked-QR kernel wrapper is given."""
    seen = []
    for name in ("_trailing_kernel", "_panel_cross_kernel", "_pad_cross_kernel"):
        real = getattr(ops, name)

        def spy(*args, _real=real, _name=name, **kw):
            seen.append((_name, kw.get("block_rows")))
            return _real(*args, **kw)

        monkeypatch.setattr(ops, name, spy)
    return seen


@pytest.mark.parametrize("pipeline", ["auto", "off"])
@pytest.mark.parametrize("n", [12, 11], ids=["even", "ragged"])
def test_block_rows_reaches_every_blocked_sweep(rng, seen_splits, pipeline, n):
    a = rng.standard_normal((4, 40, n)).astype(np.float32)
    cfg = dict(panel_width=4, use_pallas=True, pipeline=pipeline)
    untuned = factorize(a, QRConfig(**cfg), device="cpu")
    assert seen_splits and all(br is None for _, br in seen_splits)
    seen_splits.clear()
    explicit = factorize(a, QRConfig(**cfg, block_rows=64), device="cpu")
    assert seen_splits and all(br == 64 for _, br in seen_splits)
    seen_splits.clear()
    _tune([(40, n)], ("trailing_update",))
    tuned = factorize(a, QRConfig(**cfg), device="cpu")
    assert seen_splits and all(br == 32 for _, br in seen_splits)
    for res in (explicit, tuned):
        assert torch.equal(res.r, untuned.r)


def test_eager_driver_pins_the_untuned_split_under_a_narrower_table(rng, seen_splits):
    """With no entry for the whole geometry, the eager driver's sweeps keep
    the kernels' own split even where a narrower class has an entry, so it
    sums the rows the pipeline does."""
    a = rng.standard_normal((4, 40, 12)).astype(np.float32)
    _tune([(40, 8)], ("trailing_update",))
    factorize(a, QRConfig(panel_width=4, use_pallas=True, pipeline="off"), device="cpu")
    assert seen_splits and all(br is None for _, br in seen_splits)


@pytest.mark.parametrize("n", [12, 11], ids=["even", "ragged"])
def test_explicit_block_rows_counts_equal_reference(rng, n):
    """``QRConfig(block_rows=b, use_pallas=True)``: the pipeline keys its
    sweeps on b and the eager driver's wrappers resolve b, so the two
    share kernel traces on both sides; every call's counts are equal."""
    import jax

    jax.clear_caches()
    replay.clear()
    dispatch._KERNEL_SIGNATURES.clear()
    a = rng.standard_normal((4, 40, n)).astype(np.float32)
    for pipeline in ("auto", "off", "auto", "off"):
        cfg = dict(panel_width=4, use_pallas=True, block_rows=64, pipeline=pipeline)
        got, want = _counted(lambda: jfactorize(jnp.asarray(a), JQRConfig(**cfg)),
                             lambda: factorize(a, QRConfig(**cfg), device="cpu"))
        assert got == want, pipeline
