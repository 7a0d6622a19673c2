"""The port's QR serving (``repro_torch.serve``) against the JAX package's
(``repro.serve``), on the CPU, at the reference tests' sizes.

Every case of tests/test_qr_serving.py runs on both sides on the same numpy
inputs.  Bucket routing, padding, fillers, validation, the planner's
decisions (candidates included) and the server's configs, stats, dispatches
per drain and ``prewarm()`` dicts (``kernel:<op>`` traces and totals
included) are equal exactly.  A served R agrees with the reference's within
1e-5 of max|R| (both sides factor the same padded f32 matrices; the
difference is float32 rounding, ~1e-6 here), and with numpy's within 5e-4,
the reference tests' limit.  Within the port, warm serving traces nothing
and a re-served R equals a fault-free eager re-run bit for bit.  The
launcher runs in fresh processes on both sides, so its trace counts do not
depend on what this process ran before.
"""
import asyncio
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.qr import Pipeline as JPipeline  # noqa: E402
from repro.qr import factorize as jfactorize  # noqa: E402
from repro.serve import buckets as jbuckets  # noqa: E402

from repro_torch import replay  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.qr import Pipeline, factorize  # noqa: E402
from repro_torch.serve import buckets as tbuckets  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
P = 4
BUCKETS = ((64, 8), (128, 16))          # tests/test_qr_serving.py's geometry
R_TOL = 1e-5                            # of max|R|, port against reference
NP_TOL = dict(rtol=5e-4, atol=5e-4)     # against numpy, the reference tests'

SIDES = {"reference": (jserve, jbuckets, jdispatch), "port": (tserve, tbuckets, dispatch)}


def _server(side, **kw):
    serve = SIDES[side][0]
    if side == "port":
        kw["device"] = "cpu"
    return serve.QRServer([serve.BucketSpec(*b) for b in BUCKETS], p=P,
                          model=serve.CostModel(max_batch_cap=2), **kw)


def _injector(side, period, **kw):
    return SIDES[side][0].PeriodicFaultInjector.sampled(period, variant="redundant", p=P, **kw)


def _sign_normalized_r(a):
    r = np.linalg.qr(a, mode="r")
    sign = np.sign(np.diag(r))
    sign[sign == 0] = 1.0
    return (r.T * sign).T


def _stream(rng, n=8):
    shapes = [(40, 6), (120, 14), (56, 8), (96, 12)]
    return [rng.standard_normal(shapes[i % len(shapes)]).astype(np.float32) for i in range(n)]


def _assert_r_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= R_TOL * scale


@pytest.fixture(scope="module", autouse=True)
def _cold_caches():
    """The module starts with both sides' program caches and kernel-trace
    signatures empty: another test file in the same process may have
    warmed one side only."""
    jax.clear_caches()
    replay.clear()
    dispatch._KERNEL_SIGNATURES.clear()


@pytest.fixture(scope="module")
def prewarmed():
    """The first server of each side in this module, prewarmed: its dict is
    the cold one (both processes' caches are cold for this geometry)."""
    return {side: _server(side).prewarm() for side in SIDES}


# ---------------------------------------------------------------------------
# Buckets and padding (pure host logic)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", sorted(SIDES))
def test_mixed_shapes_land_in_expected_buckets(side):
    serve = SIDES[side][0]
    server = _server(side)
    spec = serve.BucketSpec
    assert server.bucket_of(40, 6) == spec(64, 8)
    assert server.bucket_of(56, 8) == spec(64, 8)
    assert server.bucket_of(120, 14) == spec(128, 16)
    assert server.bucket_of(96, 8) == spec(128, 16)
    assert server.bucket_of(62, 6) == spec(64, 8)
    assert server.bucket_of(63, 6) == spec(128, 16)
    with pytest.raises(ValueError, match="no bucket admits"):
        server.bucket_of(256, 8)
    with pytest.raises(ValueError, match="no bucket admits"):
        server.bucket_of(64, 20)


def test_routing_equals_reference():
    """Every (m, n) up to the largest bucket routes to the same bucket, and
    the same shapes are refused."""
    ladders = [(jserve.default_buckets(), tserve.default_buckets())]
    ladders.append(tuple(tuple(s.BucketSpec(*b) for b in BUCKETS) for s in (jserve, tserve)))
    for jb, tb in ladders:
        assert [dataclasses.astuple(b) for b in jb] == [dataclasses.astuple(b) for b in tb]
        for m in range(1, 1100, 7):
            for n in range(1, 140, 3):
                try:
                    want = dataclasses.astuple(jserve.bucket_for(jb, m, n))
                except ValueError:
                    want = None
                try:
                    got = dataclasses.astuple(tserve.bucket_for(tb, m, n))
                except ValueError:
                    got = None
                assert got == want, (m, n)


def test_default_buckets_cover_ladder():
    for serve in (jserve, tserve):
        buckets = serve.default_buckets()
        assert serve.bucket_for(buckets, 200, 30) == serve.BucketSpec(256, 32)
        assert serve.bucket_for(buckets, 900, 100) == serve.BucketSpec(1024, 128)


@pytest.mark.parametrize("m,n,bucket", [(40, 6, (64, 8)), (62, 6, (64, 8)), (56, 8, (64, 8)),
                                         (96, 12, (128, 16)), (3, 1, (128, 16))])
def test_pad_request_identity_extension(rng, m, n, bucket):
    a = rng.standard_normal((m, n)).astype(np.float32)
    padded = tserve.pad_request(a, tserve.BucketSpec(*bucket))
    want = jserve.pad_request(a, jserve.BucketSpec(*bucket))
    assert padded.dtype == want.dtype and np.array_equal(padded, want)
    k = bucket[1] - n
    np.testing.assert_array_equal(padded[:m, :n], a)
    np.testing.assert_array_equal(padded[m:m + k, n:], np.eye(k))
    assert not padded[m:, :n].any() and not padded[:m, n:].any() and not padded[m + k:].any()
    r_pad = _sign_normalized_r(padded.astype(np.float64))
    np.testing.assert_allclose(tserve.extract_r(r_pad, n),
                               _sign_normalized_r(a.astype(np.float64)), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(r_pad[n:, n:], np.eye(k), atol=1e-12)
    assert np.array_equal(tbuckets.block_rows(padded, P), jbuckets.block_rows(want, P))


@pytest.mark.parametrize("bucket", [(64, 8), (128, 16), (256, 32), (512, 64)])
def test_filler_matrix_is_orthonormal(bucket):
    fill = tserve.filler_matrix(tserve.BucketSpec(*bucket))
    assert np.array_equal(fill, jserve.filler_matrix(jserve.BucketSpec(*bucket)))
    np.testing.assert_array_equal(fill.T @ fill, np.eye(bucket[1]))


@pytest.mark.parametrize("side", sorted(SIDES))
def test_bucket_validation(side):
    serve, buckets, _ = SIDES[side]
    with pytest.raises(ValueError, match="tall-or-square"):
        serve.BucketSpec(8, 64)
    with pytest.raises(ValueError, match="divisible"):
        buckets.validate_buckets((serve.BucketSpec(66, 8),), 4)
    with pytest.raises(ValueError, match="duplicate"):
        buckets.validate_buckets((serve.BucketSpec(64, 8), serve.BucketSpec(64, 8)), 4)
    with pytest.raises(ValueError, match="not divisible"):
        buckets.block_rows(np.zeros((66, 8), np.float32), 4)
    with pytest.raises(ValueError, match="does not admit"):
        serve.pad_request(np.zeros((64, 8), np.float32), serve.BucketSpec(64, 4))


# ---------------------------------------------------------------------------
# Planner (pure arithmetic: equal exactly)
# ---------------------------------------------------------------------------

MODELS = [
    dict(),
    dict(max_batch_cap=2),
    dict(max_batch_cap=6),
    dict(batch_bytes_budget=64 * 8 * 4 * 3),
    dict(batch_bytes_budget=1024 * 128 * 4),
    # constants of the size chip_smoke.py measures on an H100
    dict(mem_bw_bytes_per_s=3.0e12, flops_per_s=5.0e13),
]
SPECS = [(64, 8), (128, 16), (256, 32), (512, 64), (1024, 128),
         (1 << 16, 64), (1 << 17, 128), (1 << 18, 256)]


@pytest.mark.parametrize("model", MODELS, ids=str)
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_plans_equal_reference(model, p):
    for bucket in SPECS:
        for deficient in (True, False):
            got = tserve.plan_bucket(tserve.BucketSpec(*bucket), p, tserve.CostModel(**model),
                                     rank_deficient_inputs=deficient)
            want = jserve.plan_bucket(jserve.BucketSpec(*bucket), p, jserve.CostModel(**model),
                                      rank_deficient_inputs=deficient)
            assert got.as_dict() == want.as_dict(), (bucket, deficient)


def test_planner_is_deterministic():
    a = tserve.plan_bucket(tserve.BucketSpec(256, 32), 4)
    assert a == tserve.plan_bucket(tserve.BucketSpec(256, 32), 4)


def test_cost_model_tuned_is_the_untuned_reference():
    """No tuner yet (ROADMAP A.14): ``tuned()`` is the reference's result
    with no autotune table installed."""
    assert dataclasses.asdict(tserve.CostModel.tuned()) == dataclasses.asdict(
        jserve.CostModel())
    assert tserve.CostModel.tuned(flops_per_s=1.0).flops_per_s == 1.0


@pytest.mark.parametrize("serve", [jserve, tserve], ids=["reference", "port"])
def test_planner_marks_chol_inadmissible_for_serving(serve):
    plan = serve.plan_bucket(serve.BucketSpec(256, 32), 4)
    assert plan.local_r == "jnp"
    chol_rows = [c for c in plan.candidates if c[1] == "chol"]
    assert chol_rows and all(not c[3] for c in chol_rows)
    full = serve.plan_bucket(serve.BucketSpec(256, 32), 4, rank_deficient_inputs=False)
    assert any(c[3] for c in full.candidates if c[1] == "chol")


@pytest.mark.parametrize("serve", [jserve, tserve], ids=["reference", "port"])
def test_planner_respects_batch_budget(serve):
    spec = serve.BucketSpec
    tight = serve.CostModel(batch_bytes_budget=spec(64, 8).area * 4 * 3)
    assert serve.plan_bucket(spec(64, 8), 4, tight).max_batch == 3
    assert serve.plan_bucket(spec(64, 8), 4, serve.CostModel(max_batch_cap=2)).max_batch == 2
    huge = serve.plan_bucket(spec(1024, 128), 4, serve.CostModel(
        batch_bytes_budget=spec(1024, 128).area * 4))
    assert huge.max_batch == 1


def test_server_configs_equal_reference():
    """On the CPU a bucket's config is the reference's field by field."""
    got, want = _server("port"), _server("reference")
    assert got.planner_decisions() == want.planner_decisions()
    for (gs, gcfg), (ws, wcfg) in zip(got.configs.items(), want.configs.items()):
        assert dataclasses.astuple(gs) == dataclasses.astuple(ws)
        assert gcfg.panel_width == got.plans[gs].panel_width
        assert gcfg.local_r == got.plans[gs].local_r == "jnp"
        for field in dataclasses.fields(gcfg):
            g, w = getattr(gcfg, field.name), getattr(wcfg, field.name)
            assert getattr(g, "value", g) == getattr(w, "value", w), field.name
    assert got.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def test_prewarm_counts_equal_reference(prewarmed):
    """The cold ``prewarm()`` dicts are equal, ``kernel:<op>`` traces
    included, and a second server's prewarm traces nothing on either side."""
    assert prewarmed["port"] == prewarmed["reference"]
    assert prewarmed["port"]["batched_pipeline"] >= len(BUCKETS)
    for side in SIDES:
        assert _server(side).prewarm() == {"batched_pipeline": 0, "eager_fallback": 0}


def _serve_both(rng, prewarmed, n=8, **kw):
    mats = _stream(rng, n)
    out = {}
    for side in SIDES:
        server = _server(side, **{k: v(side) for k, v in kw.items()})
        server.prewarm()
        disp = SIDES[side][2]
        before = disp.trace_count()
        out[side] = (server, server.serve(mats), disp.trace_count() - before)
    return mats, out


def test_serve_matches_reference_and_drains_one_dispatch(rng, prewarmed):
    mats, out = _serve_both(rng, prewarmed)
    (server, responses, warm), (jserver, jresponses, jwarm) = out["port"], out["reference"]
    assert warm == jwarm == 0
    assert server.stats.as_dict() == jserver.stats.as_dict()
    assert server.stats.drains == 4 and server.stats.dispatches_per_drain == [1, 1, 1, 1]
    assert server.stats.filler_slots == 0
    assert [r.rid for r in responses] == list(range(len(mats)))
    for resp, jresp, a in zip(responses, jresponses, mats):
        assert resp.served_via == jresp.served_via == "batched"
        assert isinstance(resp.r, np.ndarray) and resp.r.shape == (a.shape[1], a.shape[1])
        assert (resp.rid, resp.drain_index) == (jresp.rid, jresp.drain_index)
        assert dataclasses.astuple(resp.bucket) == dataclasses.astuple(jresp.bucket)
        _assert_r_close(resp.r, np.asarray(jresp.r))
        np.testing.assert_allclose(resp.r, _sign_normalized_r(a), **NP_TOL)


def test_warm_serving_performs_zero_new_traces(rng, prewarmed):
    """Batched drains and fault re-serves after a prewarm trace nothing, on
    either side; the stats are equal."""
    _, out = _serve_both(rng, prewarmed, fault_injector=lambda side: _injector(side, 2))
    assert out["port"][2] == out["reference"][2] == 0
    assert out["port"][0].stats.as_dict() == out["reference"][0].stats.as_dict()
    assert out["port"][0].stats.faulted_drains == 2


def test_flush_tops_up_short_batches_with_fillers(rng, prewarmed):
    a = rng.standard_normal((40, 6)).astype(np.float32)
    results = {}
    for side in SIDES:
        server = _server(side)
        server.prewarm()
        assert server.submit(a) == []
        responses = server.flush()
        assert len(responses) == 1
        assert server.stats.filler_slots == 1 and server.stats.dispatches_per_drain == [1]
        results[side] = (server.stats.as_dict(), np.asarray(responses[0].r))
    assert results["port"][0] == results["reference"][0]
    _assert_r_close(results["port"][1], results["reference"][1])


def test_fault_reserves_every_affected_request_bitwise(rng, prewarmed):
    """A drain that hits an injected death re-serves every real request of
    the batch; in the port each re-served factor equals a fault-free eager
    re-run of the same padded request bit for bit, and the reference's
    within the R tolerance."""
    mats, out = _serve_both(rng, prewarmed, fault_injector=lambda side: _injector(side, 1))
    (server, responses, _), (jserver, jresponses, _) = out["port"], out["reference"]
    assert server.stats.as_dict() == jserver.stats.as_dict()
    assert all(r.served_via == "reserved" for r in responses)
    assert server.stats.reserved == len(mats)
    assert server.stats.faulted_drains == server.stats.drains
    for resp, jresp, a in zip(responses, jresponses, mats):
        cfg = dataclasses.replace(server.configs[resp.bucket], pipeline=Pipeline.OFF)
        blocks = tbuckets.block_rows(tserve.pad_request(a, resp.bucket), P)
        rerun = factorize(blocks, cfg, device="cpu")
        np.testing.assert_array_equal(resp.r, tserve.extract_r(rerun.r[0].numpy(), a.shape[1]))
        _assert_r_close(resp.r, np.asarray(jresp.r))
        np.testing.assert_allclose(resp.r, _sign_normalized_r(a), **NP_TOL)
    # the reference's own contract, for the record
    jresp, a = jresponses[0], mats[0]
    jcfg = dataclasses.replace(jserver.configs[jresp.bucket], pipeline=JPipeline.OFF)
    ref = jfactorize(jnp.asarray(jbuckets.block_rows(jserve.pad_request(a, jresp.bucket), P)), jcfg)
    np.testing.assert_array_equal(jresp.r, jserve.extract_r(np.asarray(ref.r[0]), a.shape[1]))


@pytest.mark.parametrize("seed", [0, 3])
def test_periodic_injector_strikes_on_schedule(seed):
    got, want = _injector("port", 3, seed=seed), _injector("reference", 3, seed=seed)
    for phase in ("panel", "update"):
        specs = [{k: (v.deaths, v.corrupt, v.slow) for k, v in getattr(inj.schedule, phase).items()}
                 for inj in (got, want)]
        assert specs[0] == specs[1]
    for inj in (got, want):
        strikes = [bool(inj(None, i)) for i in range(6)]
        assert strikes == [False, False, True, False, False, True]
    for serve, inj in ((tserve, got), (jserve, want)):
        with pytest.raises(ValueError, match="period"):
            serve.PeriodicFaultInjector(0, inj.schedule)
        with pytest.raises(ValueError, match="tree"):
            serve.PeriodicFaultInjector.sampled(1, variant="tree", p=P)


def test_async_frontend(rng, prewarmed):
    a = rng.standard_normal((40, 6)).astype(np.float32)
    b = rng.standard_normal((44, 7)).astype(np.float32)
    results = {}
    for side in SIDES:
        server = _server(side)
        server.prewarm()

        async def drive(server=server):
            fa = asyncio.ensure_future(server.submit_async(a))
            fb = asyncio.ensure_future(server.submit_async(b))
            await asyncio.sleep(0)           # both queued in bucket (64, 8)
            server.flush()
            return await asyncio.gather(fa, fb)

        results[side] = asyncio.run(drive())
    (ra, rb), (ja, jb) = results["port"], results["reference"]
    assert (ra.rid, rb.rid) == (ja.rid, jb.rid) == (0, 1)
    for got, want, x in ((ra, ja, a), (rb, jb, b)):
        _assert_r_close(got.r, np.asarray(want.r))
        np.testing.assert_allclose(got.r, _sign_normalized_r(x), **NP_TOL)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_submit_rejects_non_matrix(side):
    with pytest.raises(ValueError, match="one \\(m, n\\) matrix"):
        _server(side).submit(np.zeros((2, 4, 4), np.float32))


def test_server_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tserve.QRServer([tserve.BucketSpec(64, 8)]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            tserve.QRServer([tserve.BucketSpec(64, 8)])


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

_REFERENCE_LAUNCHER = """
import sys
import jax_reference
from repro.launch.serve import main
sys.argv = ["serve"] + sys.argv[1:]
main()
"""


def _launch(cmd):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600,
                         check=True)
    return out.stdout.strip().splitlines()


def _counts(lines):
    """The launcher's lines with the clock readings taken out."""
    clock = re.compile(r"in [0-9.]+s|\([0-9.]+ req/s\)|p50=[0-9.]+ms|p99=[0-9.]+ms")
    return [clock.sub("<t>", line) for line in lines]


def test_qr_launcher_prints_the_reference_counts():
    """``python -m repro_torch.launch.serve --mode qr --device cpu`` and the
    reference's launcher, each in a fresh process, print the same planner
    decisions, prewarm traces, stream counts and dispatches per drain."""
    args = ["--mode", "qr", "--requests", "24", "--fault-period", "3", "--seed", "0"]
    got = _launch([sys.executable, "-m", "repro_torch.launch.serve", *args, "--device", "cpu"])
    want = _launch([sys.executable, "-c", _REFERENCE_LAUNCHER, *args])
    assert _counts(got) == _counts(want)
    assert got[-1].startswith("dispatches/drain: [1]")
    assert any(line.startswith("prewarm: ") for line in got)


def test_qr_launcher_model_mode_waits_for_the_model_zoo():
    """``--mode model`` serves every family of the model zoo (held to the
    reference in test_torch_model_serving.py): it asks for ``--arch`` as the
    reference's does, and ``--arch mamba2-2.7b`` on the CPU, in a fresh
    process, exits 0 with the launcher's two lines."""
    from repro_torch.launch import serve as launcher

    with pytest.raises(SystemExit, match="--arch is required"):
        launcher.main(["--mode", "model"])
    lines = _launch([sys.executable, "-m", "repro_torch.launch.serve", "--mode", "model",
                     "--arch", "mamba2-2.7b", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "16", "--gen", "4"])
    assert len(lines) == 2
    assert re.fullmatch(r"arch=mamba2-2\.7b-smoke prefill\(2x16\)=[0-9.]+ms decode 4 "
                        r"steps=[0-9.]+ms \([0-9.]+ ms/tok\)", lines[0])
    assert re.fullmatch(r"generated ids\[0\]: \[\d+(, \d+){3}\]", lines[1])
