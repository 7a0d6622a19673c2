"""Single-program blocked QR — trace and dispatch counts; hard-gated (the
port of :mod:`repro.bench.cases.dispatch`), on ``device`` (``None``: the
card, where a cached program is a CUDA graph; the CPU runs it eagerly).

The program-cache claim is a *number*, twice over:

  * the fault-free blocked QR runs as **one** cached program —
    ``dispatches_per_call == 1`` and *constant in the panel count* (the
    eager per-panel driver runs O(K) kernel ops);
  * repeated calls are **zero-retrace** — ``n_traces == 1`` after a repeat
    call with identical shapes (the programs are cached per entry point,
    keyed on the statics and the input signature, :mod:`repro_torch.replay`).

Both are measured with the counters of :mod:`repro_torch.kernels.dispatch`
and hard-gated, alongside the floor that makes the pipeline shippable: its
``(Q, R, valid)`` must match the eager driver (to f32 tolerance, hard), and
the B-matrix batched program must run once and agree with the per-matrix
run.  Bit-identity with the eager driver is one of the port's held
contracts; the case records ``bit_identical_eager`` warn-gated, as the
reference does, and hard-gates the tolerance plus warm-repeat determinism.
Wall-clock p50s of the pipeline and the eager driver ride along
warn-gated: they are the factorization latency of the blocked QR, each
call ending in a synchronize on the card.

``python -m repro_torch.bench.cases.dispatch --guard`` runs the standalone
retrace guard: every guarded entry point is called twice with identical
statics, and the process exits non-zero if the second call builds any new
program.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench.registry import BenchFailure, bench_case
from repro_torch.bench.schema import Metric

__all__ = ["BATCH_TOL", "case", "check", "guard", "main", "run"]

BATCH_TOL = 1e-5          # rel. agreement of the batched program's R


def _bitwise(x, y) -> bool:
    """Bit for bit (NaN poisoning included); two Nones agree."""
    if x is None or y is None:
        return x is None and y is None
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.is_floating_point():
        x, y = x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)
    return bool(torch.equal(x, y))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(p: int = 4, m_local: int = 160, n: int = 96, panel_width: int = 32,
        batch: int = 8, use_pallas: bool = True, repeats: int = 3, device=None) -> dict:
    """Measure traces/dispatches for the pipeline, the eager driver, the
    batched program and the cached collective; return the raw numbers."""
    from repro_torch import replay
    from repro_torch.collective import SimComm, ft_allreduce_jit
    from repro_torch.collective.comm import resolve_device
    from repro_torch.kernels import dispatch as disp
    from repro_torch.qr import blocked_qr_batched, blocked_qr_sim
    from repro_torch.qr.blocked import PIPELINE_NAME

    device = resolve_device(device)
    # Make the cold-call measurement deterministic whatever ran earlier in
    # this process (warmup repeats, other cases at the same shape): drop the
    # pipeline's cached programs so the first call below traces exactly once
    # and the repeat exactly zero times.
    replay.clear(PIPELINE_NAME)

    rng = np.random.default_rng(7)
    blocks = rng.standard_normal((p, m_local, n)).astype(np.float32)
    a = torch.from_numpy(blocks).to(device)
    kw = dict(panel_width=panel_width, compute_q=True, use_pallas=use_pallas, device=device)

    # -- eager reference: O(K) dispatches, the bit-identity oracle ----------
    with disp.track_dispatch() as d_eager:
        eager = blocked_qr_sim(a, pipeline="off", **kw)

    # -- pipeline: cold call traces once, runs once -------------------------
    t0 = disp.trace_count(PIPELINE_NAME)
    with disp.track_dispatch() as d_cold:
        cold = blocked_qr_sim(a, pipeline="on", **kw)
    traces_first = disp.trace_count(PIPELINE_NAME) - t0

    # -- warm repeat: zero new traces, the same single program ---------------
    t0 = disp.trace_count(PIPELINE_NAME)
    with disp.track_dispatch() as d_warm:
        warm = blocked_qr_sim(a, pipeline="on", **kw)
    traces_second = disp.trace_count(PIPELINE_NAME) - t0

    # -- K-independence: half the panel width → double the panels, still 1 --
    with disp.track_dispatch() as d_half:
        half = blocked_qr_sim(a, pipeline="on", panel_width=panel_width // 2,
                              compute_q=True, use_pallas=use_pallas, device=device)
    n_panels_half = half.n_panels
    del half

    scale = float(cold.r.abs().max())
    # -- batched: B matrices, one program -----------------------------------
    ab = rng.standard_normal((batch, p, m_local, n)).astype(np.float32)
    ab[0] = blocks
    with disp.track_dispatch() as d_batch:
        batched = blocked_qr_batched(torch.from_numpy(ab).to(device), panel_width=panel_width,
                                     use_pallas=use_pallas, device=device)
    batch_err = float((batched.r[0] - cold.r).abs().max()) / scale
    del batched, ab

    # -- the cached collective itself is retrace-proof too ------------------
    x = torch.from_numpy(rng.standard_normal((p, 16)).astype(np.float32)).to(device)
    comm = SimComm(p, device)
    ft_allreduce_jit(x, comm, op="sum")
    t0 = disp.trace_count("ft_allreduce")
    ft_allreduce_jit(x, comm, op="sum")
    allreduce_retrace = disp.trace_count("ft_allreduce") - t0

    # -- warn-gated wall clock: pipeline vs eager (both warm by now) --------
    def p50_us(fn):
        samples = []
        for _ in range(max(1, repeats)):
            _sync(device)
            t = time.perf_counter()
            fn()
            _sync(device)
            samples.append((time.perf_counter() - t) * 1e6)
        return float(np.percentile(samples, 50))

    time_pipeline = p50_us(lambda: blocked_qr_sim(a, pipeline="on", **kw))
    time_eager = p50_us(lambda: blocked_qr_sim(a, pipeline="off", **kw))

    return {
        "p": p, "m_local": m_local, "n": n, "panel_width": panel_width,
        "batch": batch, "n_panels": cold.n_panels,
        "traces_first": traces_first,
        "traces_second": traces_second,
        "dispatches_cold": d_cold.dispatches[PIPELINE_NAME],
        "dispatches_warm": d_warm.dispatches[PIPELINE_NAME],
        "dispatches_half_width": d_half.dispatches[PIPELINE_NAME],
        "n_panels_half_width": n_panels_half,
        "dispatches_batched": d_batch.dispatches[PIPELINE_NAME],
        "eager_kernel_dispatches": d_eager.n_dispatches,
        "bit_identical_eager": (
            _bitwise(cold.r, eager.r) and _bitwise(cold.valid, eager.valid)
            and _bitwise(cold.q, eager.q)
        ),
        "eager_rel_err": float((cold.r - eager.r).abs().max()) / scale,
        "valid_identical": _bitwise(cold.valid, eager.valid),
        "bit_identical_warm": _bitwise(cold.r, warm.r) and _bitwise(cold.q, warm.q),
        "batch_rel_err": batch_err,
        "allreduce_retrace": allreduce_retrace,
        "time_pipeline_p50_us": time_pipeline,
        "time_eager_p50_us": time_eager,
    }


def check(rows: dict) -> None:
    """The case's gates on :func:`run`'s numbers; raises
    :class:`~repro_torch.bench.registry.BenchFailure`."""
    if rows["eager_rel_err"] > BATCH_TOL or not rows["valid_identical"]:
        raise BenchFailure(
            "the fixed-shape pipeline deviates from the eager per-panel "
            f"driver by {rows['eager_rel_err']:.2e} rel "
            f"(tolerance {BATCH_TOL:.0e}; valid identical: {rows['valid_identical']})"
        )
    if not rows["bit_identical_warm"]:
        raise BenchFailure("a warm pipeline repeat changed the result bits")
    if rows["traces_second"] != 0:
        raise BenchFailure(
            f"{rows['traces_second']} new trace(s) on a repeat call with "
            "identical shapes — the zero-retrace contract failed"
        )
    if rows["dispatches_cold"] != 1 or rows["dispatches_half_width"] != 1:
        raise BenchFailure(
            "the pipeline ran more than one program "
            f"(K={rows['n_panels']}: {rows['dispatches_cold']}, "
            f"K={rows['n_panels_half_width']}: {rows['dispatches_half_width']}) — "
            "the dispatch count must be constant in the panel count"
        )
    if rows["batch_rel_err"] > BATCH_TOL:
        raise BenchFailure(
            f"batched element deviates from the single-matrix pipeline by "
            f"{rows['batch_rel_err']:.2e} (tolerance {BATCH_TOL:.0e})"
        )


def case(p: int = 4, m_local: int = 160, n: int = 96, panel_width: int = 32,
         batch: int = 8, use_pallas: bool = True, device=None):
    rows = run(p=p, m_local=m_local, n=n, panel_width=panel_width,
               batch=batch, use_pallas=use_pallas, device=device)
    check(rows)
    hard = dict(gate="hard", direction="exact")
    return {
        # THE claims: one trace total after a repeat, one program per call,
        # constant in K, one program for the whole batch
        "n_traces_total": Metric(rows["traces_first"] + rows["traces_second"], **hard),
        "n_traces_second_call": Metric(rows["traces_second"], **hard),
        "dispatches_per_call": Metric(rows["dispatches_cold"], **hard),
        "dispatches_half_panel_width": Metric(rows["dispatches_half_width"], **hard),
        "dispatches_batched": Metric(rows["dispatches_batched"], **hard),
        "batched_b": Metric(rows["batch"], **hard),
        "allreduce_retrace": Metric(rows["allreduce_retrace"], **hard),
        "valid_identical": Metric(rows["valid_identical"], **hard),
        # recorded warn-gated, as the reference does; the f32 bound above is
        # the hard gate
        "bit_identical_eager": Metric(rows["bit_identical_eager"], gate="warn",
                                      direction="exact"),
        "eager_rel_err": Metric(rows["eager_rel_err"], gate="warn", direction="lower"),
        # context + warn-gated comparisons
        "n_panels": Metric(rows["n_panels"], **hard),
        "eager_kernel_dispatches": Metric(rows["eager_kernel_dispatches"], gate="warn",
                                          direction="lower"),
        "batch_rel_err": Metric(rows["batch_rel_err"], gate="warn", direction="lower"),
        "time_pipeline_p50_us": Metric(rows["time_pipeline_p50_us"], gate="warn",
                                       direction="lower", unit="us"),
        "time_eager_p50_us": Metric(rows["time_eager_p50_us"], gate="warn",
                                    direction="lower", unit="us"),
    }


# Run as ``python -m``, this file executes a second time as ``__main__``
# after its package has imported (and registered) it; registering that copy
# too would raise the registry's duplicate-name error, which is what the
# reference's own entry point does.
if __name__ != "__main__":
    bench_case(
        "dispatch",
        tags=("qr", "blocked", "compile", "throughput"),
        params={
            "smoke": {"p": 4, "m_local": 160, "n": 96, "panel_width": 32, "batch": 8},
            # the acceptance shape: 4096×512, panel width 128, 8 ranks, B=8
            "full": {"p": 8, "m_local": 512, "n": 512, "panel_width": 128, "batch": 8},
        },
    )(case)


# ---------------------------------------------------------------------------
# Standalone retrace guard
# ---------------------------------------------------------------------------

def _prints() -> bool:
    """Inside a rank world only rank 0 prints the guard's lines."""
    import torch.distributed as dist

    from repro_torch.collective.dist import world_mesh

    return world_mesh() is None or dist.get_rank() == 0


def _report(label: str, delta: int) -> int:
    status = "ok" if delta == 0 else f"RETRACED x{delta}"
    if _prints():
        print(f"[retrace-guard] {label}: {status}")
    return int(delta != 0)


def _guarded(name: str, fn, label: str | None = None) -> int:
    """Call ``fn`` twice; print the guard's line; 1 if the second call
    traced ``name`` (``None``: any entry point) again, else 0."""
    from repro_torch.kernels import dispatch as disp

    fn()                                         # warm (may trace)
    before = disp.trace_count(name)
    fn()                                         # must not trace again
    return _report(label or name, disp.trace_count(name) - before)


def guard(device=None) -> int:
    """Call every guarded entry point twice with identical statics on
    ``device`` (``None``: the card); return the number of entry points that
    re-traced on the second call.

    The reference's four mesh checks (``blocked_qr_shard_map`` twice,
    ``tsqr_shard_map``, ``tsqr_gram_shard_map``) run on a one-device mesh;
    the port runs them in this process on a mesh of this rank alone
    (:func:`~repro_torch.collective.dist.local_mesh`).  The reference's
    ``ShardMapComm`` check joins where it sees at least four devices; the
    port's joins where the guard runs inside a rank world of at least four
    ranks (every rank of the world runs the guard, the first four run that
    check, and only rank 0 prints).  The guard never spawns that world."""
    import contextlib
    import shutil
    import tempfile

    from repro_torch.collective import DistComm, FaultSpec, SimComm, ft_allreduce_jit
    from repro_torch.collective import dist as rank_world
    from repro_torch.collective.comm import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import dispatch as disp
    from repro_torch.kernels import ops as kops
    from repro_torch.qr import (
        QRConfig,
        blocked_qr_batched,
        blocked_qr_shard_map,
        blocked_qr_sim,
        factorize,
        tsqr_gram_shard_map,
        tsqr_shard_map,
    )
    from repro_torch.runtime.elastic import ReplicaMesh, rebuild_mesh
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.serve import BucketSpec, CostModel, PeriodicFaultInjector, QRServer

    world = rank_world.world_mesh()
    device = resolve_device(device if device is not None or world is None else world.device)
    cfg_coded = QRConfig(panel_width=None, redundancy="coded", parity=2)
    spec_coded = FaultSpec.of({1: 0})
    rng = np.random.default_rng(0)

    def tensor(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    a = tensor((4, 96, 40))
    ab = tensor((2, 4, 96, 40))
    flat = tensor((128, 24))
    x = tensor((4, 32))
    stack = contextlib.ExitStack()
    mesh = stack.enter_context(rank_world.local_mesh("x", device))
    checks = [
        ("blocked_qr_pipeline",
         lambda: blocked_qr_sim(a, panel_width=12, pipeline="on", device=device)),
        # fused (stacked-payload) and two-butterfly pipelines are distinct
        # cached programs — guard both schedules
        ("blocked_qr_pipeline",
         lambda: blocked_qr_sim(a, panel_width=12, pipeline="on", fuse="on", device=device)),
        ("blocked_qr_pipeline",
         lambda: blocked_qr_sim(a, panel_width=12, pipeline="on", fuse="off", device=device)),
        ("blocked_qr_pipeline",
         lambda: blocked_qr_batched(ab, panel_width=12, device=device)),
        # on a mesh of one rank the local block is the whole matrix
        ("blocked_qr_pipeline",
         lambda: blocked_qr_shard_map(flat, mesh=mesh, axis="x", panel_width=8)),
        ("blocked_qr_pipeline",
         lambda: blocked_qr_shard_map(flat, mesh=mesh, axis="x", panel_width=8, fuse="off")),
        ("tsqr_shard_map", lambda: tsqr_shard_map(flat, mesh=mesh, axis="x")),
        ("tsqr_gram_shard_map", lambda: tsqr_gram_shard_map(flat, mesh=mesh, axis="x")),
        ("ft_allreduce",
         lambda: ft_allreduce_jit(x, SimComm(4, device), op="sum")),
        # coded warm paths: fault-free and faulted plans are distinct cached
        # programs keyed on (config, plan) — guard both
        ("tsqr_coded", lambda: factorize(a, cfg_coded, device=device)),
        ("tsqr_coded", lambda: factorize(a, cfg_coded, faults=spec_coded, device=device)),
        # a jnp slice is a new array: the kernels take contiguous operands
        ("kernel:trailing_update",
         lambda: kops.trailing_update(
             flat, flat[:, :8].contiguous(),
             torch.zeros((8, 24), dtype=torch.float32, device=device),
             next_width=8, use_pallas=True)),
    ]
    # DistComm: the cached per-rank butterfly over the first four ranks of
    # a world is retrace-proof too — keyed on (mesh, comm, plan, combiner);
    # each rank passes its (1, 32) row of x.
    if world is not None and world.size >= 4:
        smesh = rank_world.sub_mesh(4, "x")        # every rank of the world joins
        if smesh is not None:
            xr = x[smesh.rank:smesh.rank + 1]
            checks.append(
                ("ft_allreduce",
                 lambda: ft_allreduce_jit(xr, DistComm(4, "x", smesh.group, device), op="sum",
                                          mesh=smesh)))
    with stack:
        failures = sum(_guarded(name, fn) for name, fn in checks)

    # Serving warm path: after prewarm and one mixed-shape pass (batched
    # drains AND the fault re-serve fallback), a second pass over the whole
    # bucket set must add zero traces of ANY kind — the shape buckets are
    # the complete set of program classes.
    server = QRServer(
        (BucketSpec(64, 8), BucketSpec(128, 16)), p=4,
        model=CostModel(max_batch_cap=2),
        fault_injector=PeriodicFaultInjector.sampled(2, variant="redundant", p=4),
        device=device,
    )
    server.prewarm()
    mats = [rng.standard_normal(s).astype(np.float32)
            for s in ((40, 6), (120, 14), (56, 8), (96, 12))]
    failures += _guarded(None, lambda: server.serve(mats), "serving:warm_stream")

    # Train-step warm path: both FT optimizers, plus a step after an elastic
    # rebuild of the template mesh — the rebuilt mesh must find the same
    # cached step as the original (zero traces for all three warm calls
    # together).  The port's replicas share one device, so the data axis is
    # always 4 wide.
    width = 4
    cfg_t = get_config("olmo-1b").smoke(n_layers=1)
    dc = DataConfig(vocab=cfg_t.vocab, seq_len=16, global_batch=2 * width)
    for opt in ("powersgd", "orthosgd"):
        tmp = tempfile.mkdtemp(prefix="guard_train_")
        try:
            tr = Trainer(
                cfg_t,
                TrainerConfig(steps=2, log_every=10**9, ckpt_every=0, optimizer=opt,
                              ckpt_dir=tmp),
                ReplicaMesh.of((width, 1), ("data", "model")), dc, device=device,
            )
            corpus = SyntheticCorpus(dc, device)
            p, o = tr.init_state()
            p, o, _ = tr.step_fn(p, o, tr._device_batch(corpus.host_batch(0)))   # warm
            before = disp.trace_count("train_step")
            p, o, _ = tr.step_fn(p, o, tr._device_batch(corpus.host_batch(1)))   # no trace
            p, o = tr._remesh(p, o, rebuild_mesh(tr._template_mesh))
            p, o, _ = tr.step_fn(p, o, tr._device_batch(corpus.host_batch(2)))   # nor here
            delta = disp.trace_count("train_step") - before
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        failures += _report(f"train_step:{opt}", delta)

    # Tuned-config warm paths: installing an autotune table changes the
    # resolved block_rows (a statics key) of its shape classes, so the first
    # tuned call may trace — but repeats must not, whether the tuned split
    # comes from the installed table (kernel wrapper and pipeline lookup) or
    # from an explicit ``QRConfig.block_rows``.  A scripted clock keeps the
    # tuning itself deterministic and instant.
    ticks = iter(range(1, 1 << 20))
    at.tune([(96, 40)], ("gram", "trailing_update"), device=device,
            timer=lambda: next(ticks) * 1e-4, reps=1, measure_top=2, out_dir=None)
    try:
        tuned_checks = [
            ("kernel:gram", lambda: kops.gram(a[0], use_pallas=True)),
            ("blocked_qr_pipeline",
             lambda: factorize(a, QRConfig(panel_width=12), device=device)),
            ("blocked_qr_pipeline",
             lambda: factorize(a, QRConfig(panel_width=12, block_rows=16), device=device)),
        ]
        for name, fn in tuned_checks:
            failures += _guarded(name, fn, f"tuned:{name}")
    finally:
        at.clear()                               # never leak tuned state
    return failures


def main(argv: list[str] | None = None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.cases.dispatch")
    ap.add_argument("--guard", action="store_true", help="run the retrace guard")
    ap.add_argument("--device", default=None, help="cpu for the CPU (default: the card)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.guard:
        failures = guard(device=args.device)
        if failures:
            print(f"[retrace-guard] {failures} entry point(s) re-traced", file=sys.stderr)
        return 1 if failures else 0
    print("# blocked QR single-program dispatch/trace accounting")
    for k, v in run(device=args.device).items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
