"""The training loop as one fault-tolerant cached step — hard-gated (the port
of :mod:`repro.bench.cases.training`), on ``device`` (``None``: the card).

Measured four ways:

  * **one dispatch per warm train step** — PowerSGD's butterfly reductions
    with FT-TSQR and OrthoSGD's FT-CQR2 Gram butterflies run *inside* the
    step, so a warm step runs exactly one ``train_step`` program and builds
    nothing;
  * **zero retraces across elastic recovery** — a shrink→rebuild round trip
    builds one step per mesh *equivalence class* (two in all), and a
    post-rebuild step — plus an explicit ``rebuild_mesh`` of the template —
    builds **nothing**: the rebuilt mesh finds the original's cached step
    (``mesh_fingerprint``);
  * **loss parity with the non-FT baseline** — the same optimizer with every
    in-step collective replaced by its dense equivalent
    (``ft_grad_allreduce=False, ft_in_step=False``) must land within
    ``PARITY_TOL`` relative on the final loss: the butterfly changes the
    association order, never the mathematics;
  * **the model zoo survives the stock fault schedules** — MoE and SSM
    (smoke; also hybrid and multimodal at the full tier) through elastic
    shrink→rebuild, cascading failures and BLANK-under-repeat, with the
    survivor/recovery counters hard-gated through ``Trainer.fault_stats``.

The reference skips below 4 devices; the port's replicas live on one device
(:class:`~repro_torch.runtime.elastic.ReplicaMesh`), so it always runs.
"""
from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np

from repro_torch.bench.registry import BenchFailure, bench_case
from repro_torch.bench.schema import Metric

__all__ = ["PARITY_TOL", "case"]

# FT vs dense-baseline final-loss tolerance.  Both runs do the same
# mathematics; the butterfly only reassociates sums (per-replica gradients
# and a tree combine vs one fused reduction), which over a handful of
# optimizer steps stays well inside 1e-3 relative.
PARITY_TOL = 5e-3

_DATA_WIDTH = 4


def _mk(arch="olmo-1b", optimizer="adamw", *, n_layers=1, steps=6, on_failure="blank",
        ft=True, seed=0, device=None):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.elastic import ReplicaMesh
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config(arch).smoke(n_layers=n_layers)
    mesh = ReplicaMesh.of((_DATA_WIDTH, 1), ("data", "model"))
    tcfg = TrainerConfig(
        steps=steps, log_every=10**9, ckpt_every=0, optimizer=optimizer,
        on_failure=on_failure, ckpt_dir=tempfile.mkdtemp(prefix="bench_training_"),
        ft_grad_allreduce=ft, ft_in_step=ft, seed=seed,
    )
    dc = DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=2 * _DATA_WIDTH, family=cfg.family,
        enc_frames=cfg.enc_frames if cfg.family == "encdec" else 0, d_model=cfg.d_model,
    )
    return Trainer(cfg, tcfg, mesh, dc, device=device), dc


def _one_dispatch_warm(optimizer: str, device=None) -> dict:
    """Train 2 steps, then measure a warm third step."""
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.kernels import dispatch as disp

    tr, dc = _mk(optimizer=optimizer, steps=2, device=device)
    try:
        p, o = tr.init_state()
        p, o = tr.run(p, o)
        batch = tr._device_batch(SyntheticCorpus(dc, tr.device).host_batch(7))
        before = disp.trace_count("train_step")
        with disp.track_dispatch() as d:
            p, o, metrics = tr.step_fn(p, o, batch)
        return {
            "trace_delta": disp.trace_count("train_step") - before,
            "dispatches": d.dispatches.get("train_step", 0),
            "total_dispatches": d.n_dispatches,
            "loss": float(metrics["loss"]),
        }
    finally:
        shutil.rmtree(tr.tcfg.ckpt_dir, ignore_errors=True)


def _loss_parity(optimizer: str, steps: int, device=None) -> dict:
    losses = {}
    for ft in (True, False):
        tr, _ = _mk(optimizer=optimizer, steps=steps, ft=ft, device=device)
        try:
            tr.run()
            series = [m["loss"] for m in tr.metrics_log]
            if not np.isfinite(series).all():
                raise BenchFailure(
                    f"{optimizer} ({'FT' if ft else 'baseline'}) produced "
                    f"non-finite losses: {series}"
                )
            losses[ft] = series
        finally:
            shutil.rmtree(tr.tcfg.ckpt_dir, ignore_errors=True)
    final_ft, final_base = losses[True][-1], losses[False][-1]
    rel = abs(final_ft - final_base) / max(abs(final_base), 1e-9)
    return {"final_ft": final_ft, "final_base": final_base, "rel": rel}


def _elastic_zero_retrace(optimizer: str, device=None) -> dict:
    """Shrink→rebuild under real events: one trace per mesh class, and a
    rebuilt mesh (plus an extra explicit rebuild) reuses the warm step."""
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.kernels import dispatch as disp
    from repro_torch.runtime.elastic import rebuild_mesh
    from repro_torch.runtime.trainer import FaultEvent

    tr, dc = _mk(optimizer=optimizer, steps=8, on_failure="shrink", device=device)
    try:
        p, o = tr.init_state()
        before = disp.trace_count("train_step")
        t0 = time.perf_counter()
        p, o = tr.run(p, o, fault_schedule=(
            FaultEvent(step=3, kind="fail", replica=1),
            FaultEvent(step=6, kind="rejoin"),
        ))
        wall = time.perf_counter() - t0          # the run's losses are read as floats
        traces_run = disp.trace_count("train_step") - before
        # the template mesh rebuilt once more, and a warm step on it, must
        # build nothing
        before = disp.trace_count("train_step")
        p, o = tr._remesh(p, o, rebuild_mesh(tr._template_mesh))
        batch = tr._device_batch(SyntheticCorpus(dc, tr.device).host_batch(11))
        with disp.track_dispatch() as d:
            p, o, _ = tr.step_fn(p, o, batch)
        losses = [m["loss"] for m in tr.metrics_log]
        return {
            "traces_across_elastic": traces_run,
            "post_rebuild_trace_delta": disp.trace_count("train_step") - before,
            "post_rebuild_dispatches": d.n_dispatches,
            "step_cache_entries": len(tr._step_cache),
            "fault_stats": dict(tr.fault_stats),
            "loss_finite": bool(np.isfinite(losses).all()),
            "steps_per_sec": tr.tcfg.steps / wall,
        }
    finally:
        shutil.rmtree(tr.tcfg.ckpt_dir, ignore_errors=True)


def _zoo_scenarios(archs: tuple, device=None) -> dict:
    """The stock elastic / cascading / BLANK-under-repeat schedules, per
    model-zoo architecture, through the declarative scenario engine."""
    from repro_torch.bench.scenarios import TrainerScenario, run_trainer_scenario
    from repro_torch.runtime.trainer import FaultEvent

    out = {}
    for arch in archs:
        slug = arch.split("-")[0]
        schedules = (
            TrainerScenario(
                name=f"{slug}_elastic", on_failure="shrink",
                arch=arch, n_layers=1, steps=8, ckpt_every=0,
                events=(FaultEvent(step=3, kind="fail", replica=1),
                        FaultEvent(step=6, kind="rejoin")),
                expect={"failures": 1, "shrinks": 1, "rejoins": 1},
            ),
            TrainerScenario(
                name=f"{slug}_cascading", on_failure="blank",
                arch=arch, n_layers=1, steps=8, ckpt_every=0,
                events=(FaultEvent(step=2, kind="fail", replica=1),
                        FaultEvent(step=4, kind="fail", replica=2),
                        FaultEvent(step=6, kind="recover", replica=1),
                        FaultEvent(step=6, kind="recover", replica=2)),
                expect={"failures": 2, "recoveries": 2, "masked_steps": 4},
            ),
            TrainerScenario(
                name=f"{slug}_blank_repeat", on_failure="blank",
                arch=arch, n_layers=1, steps=8, ckpt_every=0,
                events=(FaultEvent(step=2, kind="fail", replica=1),
                        FaultEvent(step=4, kind="recover", replica=1),
                        FaultEvent(step=5, kind="fail", replica=2),
                        FaultEvent(step=7, kind="recover", replica=2)),
                expect={"failures": 2, "recoveries": 2, "masked_steps": 4},
            ),
        )
        for sc in schedules:
            for k, m in run_trainer_scenario(sc, device=device).items():
                out[f"{sc.name}.{k}"] = m
    return out


def case(archs: tuple = ("qwen2-moe-a2.7b", "mamba2-2.7b"), parity_steps: int = 6,
         device=None) -> dict:
    hard = dict(gate="hard", direction="exact")
    metrics: dict[str, Metric] = {}

    # -- one dispatch per warm train step, both FT optimizers ---------------
    for opt in ("powersgd", "orthosgd"):
        w = _one_dispatch_warm(opt, device)
        if w["trace_delta"] != 0 or w["total_dispatches"] != 1:
            raise BenchFailure(
                f"{opt}: warm train step traced {w['trace_delta']}x and ran "
                f"{w['total_dispatches']} program(s) — must be 0 traces / 1 dispatch"
            )
        metrics[f"{opt}.warm_trace_delta"] = Metric(w["trace_delta"], **hard)
        metrics[f"{opt}.warm_dispatches"] = Metric(w["total_dispatches"], **hard)

    # -- loss parity: FT collectives vs dense baseline ----------------------
    for opt in ("powersgd", "orthosgd"):
        pr = _loss_parity(opt, parity_steps, device)
        if pr["rel"] > PARITY_TOL:
            raise BenchFailure(
                f"{opt}: FT final loss {pr['final_ft']:.6f} deviates from dense "
                f"baseline {pr['final_base']:.6f} by {pr['rel']:.2e} rel "
                f"(tolerance {PARITY_TOL:.0e})"
            )
        metrics[f"{opt}.loss_parity_ok"] = Metric(True, **hard)
        metrics[f"{opt}.loss_parity_rel"] = Metric(pr["rel"], gate="warn", direction="lower")

    # -- elastic shrink→rebuild: zero warm retraces -------------------------
    el = _elastic_zero_retrace("powersgd", device)
    if el["traces_across_elastic"] != 2:
        raise BenchFailure(
            f"elastic run built {el['traces_across_elastic']} train-step programs — "
            "must be exactly 2 (one per mesh equivalence class)"
        )
    if el["post_rebuild_trace_delta"] != 0 or el["post_rebuild_dispatches"] != 1:
        raise BenchFailure(
            "a rebuilt template mesh did not find the warm cached step "
            f"(traces {el['post_rebuild_trace_delta']}, dispatches "
            f"{el['post_rebuild_dispatches']})"
        )
    for k, want in (("failures", 1), ("shrinks", 1), ("rejoins", 1)):
        if el["fault_stats"][k] != want:
            raise BenchFailure(
                f"elastic run fault_stats[{k!r}] = {el['fault_stats'][k]}, expected {want}"
            )
    metrics["elastic.traces_across_elastic"] = Metric(el["traces_across_elastic"], **hard)
    metrics["elastic.post_rebuild_trace_delta"] = Metric(el["post_rebuild_trace_delta"],
                                                         **hard)
    metrics["elastic.mesh_classes_compiled"] = Metric(el["step_cache_entries"], **hard)
    metrics["elastic.loss_finite"] = Metric(el["loss_finite"], **hard)
    metrics["elastic.steps_per_sec"] = Metric(el["steps_per_sec"], gate="warn",
                                              direction="higher", unit="steps/s")

    # -- model zoo under the stock fault schedules --------------------------
    metrics.update(_zoo_scenarios(tuple(archs), device))
    return metrics


bench_case(
    "training",
    tags=("robustness", "training", "compile"),
    params={
        "smoke": {"archs": ("qwen2-moe-a2.7b", "mamba2-2.7b"), "parity_steps": 6},
        "full": {"archs": ("qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-7b", "qwen2-vl-72b"),
                 "parity_steps": 8},
    },
)(case)
