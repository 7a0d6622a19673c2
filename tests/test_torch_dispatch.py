"""Trace and dispatch counts of the port's cached programs against the JAX
package's jitted entry points, on the CPU.

The same calls go through the reference and the port, and the counts each
records under ``track_dispatch`` (traces, dispatches, butterfly rounds and
overlaps by entry point) must be equal as whole dicts, the reference's
``kernel:<op>`` traces and the totals included: a cold call builds one
program (one trace), a warm repeat builds none, a kernel traces once a new
signature, and every call counts its dispatches.  On the CPU a cached
program is the body run eagerly; the CUDA graphs it becomes on the card are
checked by chip_smoke.py's replay phase.
Each test starts from empty caches on both sides (``_cold_caches``): kernel
traces are process-lifetime, and another test file run earlier in the same
process may have warmed one side only.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import collective as jc  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import traffic as jtraffic  # noqa: E402
from repro.qr import QRConfig as JQRConfig  # noqa: E402
from repro.qr import factorize as jfactorize  # noqa: E402
from repro.qr.blocked import PIPELINE_NAME as J_PIPELINE_NAME  # noqa: E402

from repro_torch import collective as tc  # noqa: E402
from repro_torch import replay  # noqa: E402
from repro_torch.kernels import dispatch, traffic  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.qr import QRConfig, factorize  # noqa: E402
from repro_torch.qr.blocked import PIPELINE_NAME  # noqa: E402

TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(autouse=True)
def _cold_caches():
    """Each test starts with both sides' program caches and kernel-trace
    signatures empty: another test file in the same process may have
    warmed one side only (a port-only call, or a reference call with
    ``interpret=True``, which the port has no counterpart of)."""
    jax.clear_caches()
    replay.clear()
    dispatch._KERNEL_SIGNATURES.clear()


def _counted(jcall, tcall):
    """Run the reference's call and the port's, each under its own
    ``track_dispatch``.  Returns ``(got, want, port counts, reference
    counts)``, the reference's ``kernel:<op>`` traces included."""
    with jdispatch.track_dispatch() as jd:
        want = jcall()
    with dispatch.track_dispatch() as td:
        got = tcall()
    return got, want, td.as_dict(), jd.as_dict()


def _factorize_both(a, **cfg):
    return _counted(lambda: jfactorize(jnp.asarray(a), JQRConfig(**cfg)),
                    lambda: factorize(a, QRConfig(**cfg), device="cpu"))


def test_pipeline_name_is_the_reference_key():
    assert PIPELINE_NAME == J_PIPELINE_NAME == "blocked_qr_pipeline"


@pytest.mark.parametrize("side", ["reference", "port"])
def test_dispatch_counters(rng, side):
    """The reference's test_dispatch_counters, run on each side."""
    disp, traf, ops = ((jdispatch, jtraffic, jops) if side == "reference"
                       else (dispatch, traffic, tops))
    with disp.track_dispatch() as d:
        disp.note_dispatch("x")
        disp.note_trace("y")
        disp.note_rounds("x", 3)
        disp.note_overlap("x", 2)
        with disp.suppress():
            disp.note_dispatch("x")
            disp.note_rounds("x", 5)
            disp.note_trace("y")          # traces are never suppressed
    assert d.n_dispatches == 1 and d.n_traces == 2
    assert d.n_rounds == 3 and d.n_overlapped == 2
    assert d.as_dict() == {
        "traces": {"y": 2},
        "dispatches": {"x": 1},
        "rounds": {"x": 3},
        "overlapped": {"x": 2},
    }
    before = disp.trace_count("y")
    disp.note_trace("y")                  # process-lifetime, outside any scope
    assert disp.trace_count("y") == before + 1
    assert disp.trace_count() >= disp.trace_count("y")
    # traffic records carry dispatches/traces alongside bytes
    a = rng.standard_normal((32, 8)).astype(np.float32)
    a = jnp.asarray(a) if side == "reference" else torch.from_numpy(a)
    with traf.track_traffic() as t:
        ops.gram(a, use_pallas=True)
        ops.gram(a, use_pallas=True)
        traf.note("panel_reduce", dispatches=0, rounds=2, wire_bytes=64, overlapped=1)
    assert t.dispatches == 2
    assert {"dispatches", "traces", "rounds", "wire_bytes"} <= set(t.records[0])
    assert t.as_dict()["dispatches"] == 2
    assert t.collective_rounds == 2 and t.rounds_of("panel_reduce") == 2
    assert t.wire_bytes == 64 and t.overlapped == 1


def _traces_of(records):
    return [(r["op"], r["traces"]) for r in records]


def test_kernel_op_dispatches_equal_reference(rng):
    """Each kernel-op wrapper counts one dispatch under its own name, and a
    ``kernel:<op>`` trace the first time its signature is seen (the kernel
    route keys on each operand's last two dims, so the 3-D and 4-D calls
    share); whole dicts and each traffic record's ``traces`` equal the
    reference's."""
    a = rng.standard_normal((2, 43, 9)).astype(np.float32)
    r1, r2 = (rng.standard_normal((2, 9, 9)).astype(np.float32) for _ in range(2))

    def calls(ops, conv):
        ops.cholesky_qr2(conv(a), use_pallas=True)
        ops.cholesky_qr2_r(conv(a), use_pallas=True)
        ops.gram(conv(a[None].repeat(3, 0)), use_pallas=True)
        ops.combine_gram(conv(r1), conv(r2), use_pallas=True)
        ops.combine_gram(conv(r1), conv(r2))
        ops.panel_cross(conv(a), split=4, use_pallas=True)
        ops.panel_cross(conv(a), split=4)
        ops.panel_cross(conv(a[:1]), split=4)
        ops.trailing_update(conv(a[..., 4:].copy()), conv(a[..., :4].copy()),
                            conv(r1[..., :4, :5].copy()), next_width=2, use_pallas=True)
        ops.pad_cross(conv(a), split=4, out_width=12)

    with jtraffic.track_traffic() as jt, traffic.track_traffic() as tt:
        _, _, got, want = _counted(lambda: calls(jops, jnp.asarray),
                                   lambda: calls(tops, torch.from_numpy))
    assert got == want
    assert got["dispatches"] == {"gram": 3, "fused_apply_gram": 2, "apply_right": 1,
                                 "combine_gram": 2, "panel_cross": 3, "trailing_update": 1,
                                 "pad_cross": 1}
    assert got["traces"] == {"kernel:gram": 1, "kernel:fused_apply_gram": 2,
                             "kernel:apply_right": 1, "kernel:combine_gram": 1,
                             "kernel:panel_cross": 3, "kernel:trailing_update": 1,
                             "kernel:pad_cross": 1}
    assert _traces_of(tt.records) == _traces_of(jt.records)
    _, _, got, want = _counted(lambda: calls(jops, jnp.asarray),
                               lambda: calls(tops, torch.from_numpy))
    assert got == want and not got["traces"]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("n", [15, 17], ids=["even", "ragged"])
def test_kernel_traces_across_blocked_routes(rng, use_pallas, n):
    """The 3-D pipeline traces its prime and its trailing sweep once, the
    batched pipeline at the same per-matrix shape no kernel anew, the eager
    driver its prime (shared with an even pipeline's on the plain route)
    and one trailing sweep a width; repeats trace nothing.  Every call's
    whole counts, and each traffic record's ``traces``, equal the
    reference's."""
    a = rng.standard_normal((4, 46, n)).astype(np.float32)
    ab = rng.standard_normal((3, 4, 46, n)).astype(np.float32)
    cfg = dict(panel_width=5, use_pallas=use_pallas)
    for x, extra in [(a, {}), (ab, {}), (a, dict(pipeline="off"))] * 2:
        with jtraffic.track_traffic() as jt, traffic.track_traffic() as tt:
            _, _, got_d, want_d = _factorize_both(x, **cfg, **extra)
        assert got_d == want_d, (x.shape, extra)
        assert _traces_of(tt.records) == _traces_of(jt.records)


@pytest.mark.parametrize("p,m_local,n,widths", [(4, 52, 19, (6, 7)), (2, 44, 13, (4, 5))])
def test_sim_pipeline_zero_retrace(rng, p, m_local, n, widths):
    """The reference's test_sim_pipeline_zero_retrace through ``factorize``
    on both sides: a repeat call builds nothing, another static config
    builds once; each call's counts equal the reference's."""
    a = rng.standard_normal((p, m_local, n)).astype(np.float32)
    for pw in widths:
        t0, j0 = dispatch.trace_count(PIPELINE_NAME), jdispatch.trace_count(J_PIPELINE_NAME)
        cold, want, got_d, want_d = _factorize_both(a, panel_width=pw)
        assert got_d == want_d
        assert got_d["traces"] == {PIPELINE_NAME: 1, "kernel:pad_cross": 1,
                                   "kernel:trailing_update": 1}
        assert got_d["dispatches"] == {PIPELINE_NAME: 1}
        assert dispatch.trace_count(PIPELINE_NAME) - t0 == (
            jdispatch.trace_count(J_PIPELINE_NAME) - j0) == 1
        np.testing.assert_allclose(cold.r.numpy(), np.asarray(want.r), **TOL)
        before = dispatch.trace_count(PIPELINE_NAME)
        warm, _, got_d, want_d = _factorize_both(a, panel_width=pw)
        assert dispatch.trace_count(PIPELINE_NAME) == before
        assert got_d == want_d and not got_d["traces"]
        assert torch.equal(warm.r, cold.r)


def test_config_hashable_and_canonical_collapses_policy_knobs():
    """The reference's test_qr_api test on the port's QRConfig."""
    a = QRConfig(panel_width=8)
    b = QRConfig(panel_width=8)
    assert a == b and hash(a) == hash(b)
    assert len({a, b}) == 1
    on = QRConfig(panel_width=8, pipeline="on", fuse="on")
    auto = QRConfig(panel_width=8, pipeline="auto", fuse="auto")
    assert on.canonical() == auto.canonical()
    off = QRConfig(panel_width=8, fuse="off")
    assert off.canonical() != auto.canonical()
    assert QRConfig(panel_width=8).canonical().local_r == "chol"
    assert QRConfig(panel_width=None).canonical().local_r == "jnp"


@pytest.mark.parametrize("cfg", [
    dict(panel_width=8, pipeline="on", fuse="on", recover="off"),
    dict(panel_width=8, fuse="off", block_rows=64),
    dict(panel_width=8, use_pallas=True, block_rows=64, parity=5),
    dict(redundancy="coded", parity=3, local_r="cqr2_pallas", compute_q=True),
    dict(panel_width=None, reorth=2),
], ids=str)
def test_canonical_equals_reference(cfg):
    """Field by field, the port's canonical config is the reference's."""
    got, want = QRConfig(**cfg).canonical(), JQRConfig(**cfg).canonical()
    for field in dataclasses.fields(got):
        g, w = getattr(got, field.name), getattr(want, field.name)
        assert getattr(g, "value", g) == getattr(w, "value", w), field.name


def test_canonical_configs_share_one_program(rng):
    """``pipeline`` and ``recover`` spellings, ``fuse="on"`` and a spelled-out
    ``local_r`` do not split the cache; ``fuse="off"`` does."""
    a = rng.standard_normal((4, 36, 11)).astype(np.float32)
    base = dict(panel_width=4)
    _, _, got_d, want_d = _factorize_both(a, **base)
    assert got_d == want_d and got_d["traces"] == {
        PIPELINE_NAME: 1, "kernel:pad_cross": 1, "kernel:trailing_update": 1}
    for same in (dict(pipeline="on"), dict(fuse="on"), dict(recover="off"),
                 dict(local_r="chol"), dict(parity=3)):
        _, _, got_d, want_d = _factorize_both(a, **base, **same)
        assert got_d == want_d and not got_d["traces"], same
    _, _, got_d, want_d = _factorize_both(a, **base, fuse="off")
    assert got_d == want_d and got_d["traces"] == {PIPELINE_NAME: 1}


def test_eager_driver_counts_equal_reference(rng):
    """The eager driver (``pipeline="off"``, or a faulted plan) builds no
    program; its kernel-op dispatches and its butterfly rounds and overlaps
    under ``blocked_qr_sim`` equal the reference's."""
    a = rng.standard_normal((4, 28, 10)).astype(np.float32)
    for cfg in (dict(pipeline="off"), dict(pipeline="off", use_pallas=True),
                dict(pipeline="off", fuse="off")):
        _, _, got_d, want_d = _factorize_both(a, panel_width=4, **cfg)
        assert got_d == want_d, cfg
        assert all(k.startswith("kernel:") for k in got_d["traces"])
        assert got_d["rounds"]["blocked_qr_sim"] > 0


def test_batched_one_dispatch_fp_tight(rng):
    """The one-dispatch half of the reference's test: B blocked
    factorizations are one program, equal to per-matrix runs, and a warm
    repeat builds nothing."""
    ab = rng.standard_normal((5, 4, 38, 18)).astype(np.float32)
    bres, want, got_d, want_d = _factorize_both(ab, panel_width=6, compute_q=True)
    assert got_d == want_d
    assert got_d["dispatches"] == {PIPELINE_NAME: 1}
    assert bres.r.shape == (5, 4, 18, 18) and bool(bres.valid.all())
    np.testing.assert_allclose(bres.r.numpy(), np.asarray(want.r), **TOL)
    for i in range(5):
        single = factorize(ab[i], QRConfig(panel_width=6, compute_q=True), device="cpu")
        scale = single.r.abs().max()
        assert ((bres.r[i] - single.r).abs().max() / scale).item() < 1e-5
        assert (bres.q[i] - single.q).abs().max().item() < 1e-5
    before = dispatch.trace_count(PIPELINE_NAME)
    _, _, got_d, want_d = _factorize_both(ab, panel_width=6, compute_q=True)
    assert dispatch.trace_count(PIPELINE_NAME) == before
    assert got_d == want_d and got_d["dispatches"] == {PIPELINE_NAME: 1}


@pytest.mark.parametrize("cfg", [dict(local_r="cqr2_pallas"), dict(local_r="jnp"),
                                 dict(local_r="cqr2", compute_q=True)], ids=str)
def test_tsqr_batched_counts(rng, cfg):
    """B TSQRs are one ``tsqr_batched`` program: the cold call also counts
    the kernel ops its body runs (the reference counts them while it
    traces), a warm repeat only the one dispatch."""
    shape = {"cqr2_pallas": (3, 4, 32, 6), "jnp": (3, 4, 28, 5), "cqr2": (2, 4, 36, 7)}
    kernels = ({"kernel:gram": 1, "kernel:fused_apply_gram": 1}
               if cfg["local_r"] == "cqr2_pallas" else {})
    ab = rng.standard_normal(shape[cfg["local_r"]]).astype(np.float32)
    cold, want, got_d, want_d = _factorize_both(ab, **cfg)
    assert got_d == want_d and got_d["traces"] == {"tsqr_batched": 1, **kernels}
    np.testing.assert_allclose(cold.r.numpy(), np.asarray(want.r), **TOL)
    before = dispatch.trace_count("tsqr_batched")
    warm, _, got_d, want_d = _factorize_both(ab, **cfg)
    assert dispatch.trace_count("tsqr_batched") == before
    assert got_d == want_d == {"traces": {}, "dispatches": {"tsqr_batched": 1},
                               "rounds": {}, "overlapped": {}}
    assert torch.equal(warm.r, cold.r)


def test_tsqr_coded_counts(rng):
    """Coded TSQR counts one ``tsqr_coded`` program per (canonical config,
    coded plan): a new fault picture builds once, a repeat nothing."""
    a = rng.standard_normal((4, 30, 6)).astype(np.float32)
    cfg = dict(local_r="cqr2_pallas", redundancy="coded", parity=2)
    _, _, got_d, want_d = _factorize_both(a, **cfg)
    assert got_d == want_d and got_d["traces"] == {
        "tsqr_coded": 1, "kernel:gram": 1, "kernel:fused_apply_gram": 1}
    _, _, got_d, want_d = _factorize_both(a, **cfg)
    assert got_d == want_d and not got_d["traces"]
    from repro.collective import FaultSpec as JFaultSpec

    from repro_torch.collective import FaultSpec

    got, want, got_d, want_d = _counted(
        lambda: jfactorize(jnp.asarray(a), JQRConfig(**cfg), faults=JFaultSpec.of({1: 0})),
        lambda: factorize(a, QRConfig(**cfg), faults=FaultSpec.of({1: 0}), device="cpu"))
    assert got_d == want_d and got_d["traces"] == {"tsqr_coded": 1}
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize("op", ["sum", "mean", "gram_sum"])
def test_ft_allreduce_jit_zero_retrace(rng, op):
    """The reference's test: a repeat builds nothing, the result equals
    ``ft_allreduce`` bit for bit (and the reference's within tolerance), a
    mesh or another backend raises."""
    n = {"sum": 6, "mean": 5, "gram_sum": 3}[op]
    x = rng.standard_normal((4, n, n)).astype(np.float32)
    comm, jcomm = tc.SimComm(4, "cpu"), jc.SimComm(4)
    (v1, ok1), (jv, jok), got_d, want_d = _counted(
        lambda: jc.ft_allreduce_jit(jnp.asarray(x), jcomm, op=op),
        lambda: tc.ft_allreduce_jit(torch.from_numpy(x), comm, op=op))
    assert got_d == want_d == {"traces": {"ft_allreduce": 1},
                               "dispatches": {"ft_allreduce": 1}, "rounds": {},
                               "overlapped": {}}
    before = dispatch.trace_count("ft_allreduce")
    (v2, ok2), _, got_d, want_d = _counted(
        lambda: jc.ft_allreduce_jit(jnp.asarray(x), jcomm, op=op),
        lambda: tc.ft_allreduce_jit(torch.from_numpy(x), comm, op=op))
    assert dispatch.trace_count("ft_allreduce") == before
    assert got_d == want_d and not got_d["traces"]
    plain = tc.ft_allreduce(torch.from_numpy(x), comm, op=op)
    assert torch.equal(v1, v2) and torch.equal(v1, plain[0]) and torch.equal(ok1, plain[1])
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(ok1.numpy(), np.asarray(jok))


def test_ft_allreduce_jit_faulted_plan_and_backends(rng):
    x = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    comm = tc.SimComm(8, "cpu")
    spec = tc.FaultSpec.of({3: 1})
    t0 = dispatch.trace_count("ft_allreduce")
    val, ok = tc.ft_allreduce_jit(x, comm, fault_spec=spec)
    want, want_ok = tc.ft_allreduce(x, comm, fault_spec=spec)
    assert torch.equal(ok, want_ok) and not bool(ok[3])
    assert torch.equal(val[ok], want[want_ok])
    tc.ft_allreduce_jit(x, comm, fault_spec=spec)
    tc.ft_allreduce_jit((x, x[:, :2]), comm, fault_spec=spec)     # another payload structure
    assert dispatch.trace_count("ft_allreduce") - t0 == 2
    # a SimComm program ignores mesh=, as the reference's does (the mesh
    # route of a DistComm is held in test_torch_dist.py)
    meshed = tc.ft_allreduce_jit(x, comm, fault_spec=spec, mesh=object())
    assert torch.equal(meshed[1], ok) and torch.equal(meshed[0][ok], val[ok])
    with pytest.raises(ValueError, match="SimComm"):
        tc.ft_allreduce_jit(x, tc.InstrumentedComm(comm))


@pytest.mark.parametrize("deaths", [{}, {0: 0}, {2: 0, 5: 1}], ids=str)
def test_coded_allreduce_jit_counts(rng, deaths):
    """The coded counterpart: one ``coded_allreduce`` program per (plan,
    combiner, structure), a repeat builds nothing, and the result equals
    ``coded_allreduce`` bit for bit and the reference's within tolerance."""
    p, c = 4, 2
    x = rng.standard_normal((p + c, 5, 3 + len(deaths))).astype(np.float32)
    comm, jcomm = tc.SimComm(p + c, "cpu"), jc.SimComm(p + c)
    plan = tc.make_coded_plan(p, c, tc.FaultSpec.of(deaths) if deaths else None)
    jplan = jc.make_coded_plan(p, c, jc.FaultSpec.of(deaths) if deaths else None)
    got, want, got_d, want_d = _counted(
        lambda: jc.coded_allreduce_jit(jnp.asarray(x), jcomm, plan=jplan),
        lambda: tc.coded_allreduce_jit(torch.from_numpy(x), comm, plan=plan))
    assert got_d == want_d == {"traces": {"coded_allreduce": 1},
                               "dispatches": {"coded_allreduce": 1}, "rounds": {},
                               "overlapped": {}}
    _, _, got_d, want_d = _counted(
        lambda: jc.coded_allreduce_jit(jnp.asarray(x), jcomm, plan=jplan),
        lambda: tc.coded_allreduce_jit(torch.from_numpy(x), comm, plan=plan))
    assert got_d == want_d and not got_d["traces"]
    plain = tc.coded_allreduce(torch.from_numpy(x), comm, plan=plan)
    valid = plain[1]
    assert torch.equal(got[1], valid) and torch.equal(got[2], plain[2])
    assert torch.equal(got[0][valid], plain[0][valid])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0][valid].numpy(), np.asarray(want[0])[valid.numpy()], **TOL)
    with pytest.raises(ValueError, match="SimComm"):
        tc.coded_allreduce_jit(torch.from_numpy(x), tc.InstrumentedComm(comm), plan=plan)
