"""Declarative fault scenarios, run on the port.

The collective and blocked-QR parts of :mod:`repro.bench.scenarios`.  A
scenario is a small deterministic schedule of faults, run and distilled
into hard-gated metrics equal to the reference's for the same scenario and
seed:

* :class:`CollectiveScenario` — a sequence of :class:`ReduceRound`\\ s, each
  one all-reduce over a :class:`~repro_torch.collective.comm.SimComm` with
  BLANK-masked replicas (zero contribution) and mid-reduce deaths, on the
  butterfly (``ft_allreduce``) or the checksum-coded scheme
  (``coded_allreduce``, which also acts on stragglers and injected silent
  corruption).  Survivor values are checked against the dense reduction,
  and the traffic is counted through
  :class:`~repro_torch.collective.instrument.InstrumentedComm`.
* :class:`BlockedQRScenario` — a :class:`~repro_torch.qr.blocked.
  PanelFaultSchedule` driven through the blocked QR, judged per panel
  against the variant's guarantee, with the one-trailing-sweep-per-panel
  claim counted through :mod:`repro_torch.kernels.traffic`.

* :class:`TrainerScenario` — a :class:`~repro_torch.runtime.trainer.
  FaultEvent` schedule driven through a small
  :class:`~repro_torch.runtime.trainer.Trainer` on a ``(data, model)``
  replica mesh, exercising the SHRINK / REBUILD / BLANK semantics end to
  end; assertions read the trainer's ``fault_stats`` counters.  The
  replicas are simulated on one device, so a scenario needs no devices and
  the reference's ``SkipCase`` branch (too few JAX devices) has no
  counterpart.

:class:`Metric` and :class:`BenchFailure` live in :mod:`.schema` and
:mod:`.registry` and are re-exported here.  Runners take ``device``
(``None`` means the GPU, as every entry point of the port).  Importing this
module registers the ``fault_scenarios`` bench case, the whole stock sweep
as one case, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.runtime.trainer import FaultEvent, Trainer, TrainerConfig

from .registry import BenchFailure, bench_case
from .schema import Metric

__all__ = [
    "BenchFailure",
    "BlockedQRScenario",
    "CollectiveScenario",
    "Metric",
    "case",
    "ReduceRound",
    "TrainerScenario",
    "get_scenarios",
    "run_blocked_qr_scenario",
    "run_collective_scenario",
    "run_scenario",
    "run_trainer_scenario",
    "trainer_scenario_metrics",
    "trainer_scenario_run",
]


# ---------------------------------------------------------------------------
# Scenario formats
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReduceRound:
    """One all-reduce inside a repeated-reduction scenario.  ``corrupt`` and
    ``slow`` act only under ``scheme="coded"``: a corrupt rank's observed
    payload is silently perturbed, a slow rank is not awaited; both are
    reconstructed from parity, and corruptions are flagged."""

    deaths: tuple[tuple[int, int], ...] = ()   # (rank, butterfly step)
    masked: tuple[int, ...] = ()               # BLANK-masked replicas
    corrupt: tuple[int, ...] = ()              # silent data corruption (SDC)
    slow: tuple[int, ...] = ()                 # stragglers


@dataclasses.dataclass(frozen=True)
class CollectiveScenario:
    name: str
    p: int
    variant: str
    rounds: tuple[ReduceRound, ...] = (ReduceRound(),)
    op: str = "sum"
    scheme: str = "butterfly"                  # "butterfly" | "coded"
    parity: int = 2                            # checksum ranks (coded only)
    description: str = ""

    kind = "collective"


@dataclasses.dataclass(frozen=True)
class TrainerScenario:
    name: str
    on_failure: str                      # blank | shrink | rebuild
    events: tuple = ()                   # FaultEvent schedule
    data_width: int = 4
    model_width: int = 1
    steps: int = 8
    ckpt_every: int = 3
    buddy_levels: int = 1
    arch: str = "olmo-1b"                # any configs/ registry name
    optimizer: str = "adamw"             # adamw | powersgd | orthosgd | lowrank
    n_layers: int = 2
    expect: Mapping[str, int] = dataclasses.field(default_factory=dict)
    description: str = ""

    kind = "trainer"


@dataclasses.dataclass(frozen=True)
class BlockedQRScenario:
    """Deaths scheduled into a blocked QR: ``panel_deaths`` /
    ``update_deaths`` map a panel index to ``((rank, butterfly_step), …)``
    of that panel's R reduction (phase 1) or cross-product reduction
    (phase 3)."""

    name: str
    p: int
    variant: str
    m_local: int = 64
    n: int = 24
    panel_width: int = 8
    panel_deaths: tuple[tuple[int, tuple[tuple[int, int], ...]], ...] = ()
    update_deaths: tuple[tuple[int, tuple[tuple[int, int], ...]], ...] = ()
    description: str = ""

    kind = "blocked"


# ---------------------------------------------------------------------------
# Runners
# ---------------------------------------------------------------------------

def _device(device):
    from repro_torch.qr.api import resolve_device

    return resolve_device(device)


def _run_coded_scenario(sc: CollectiveScenario, seed: int, device: torch.device) -> dict:
    """Coded rounds: deaths, stragglers and injected silent corruption (the
    observed payload is perturbed; parity still encodes the truth), with
    detection and wire-accounting gates."""
    from repro_torch.collective import (
        FaultSpec,
        InstrumentedComm,
        SimComm,
        coded_allreduce,
        make_coded_plan,
        reconstruction_tol,
    )

    rng = np.random.default_rng(seed)
    comm = InstrumentedComm(SimComm(sc.p + sc.parity, device))
    metrics: dict[str, Metric] = {}
    all_match = all_survived = all_detected = honest = True
    expect_msgs = expect_bytes = 0
    tol = reconstruction_tol(np.float32)
    for i, rnd in enumerate(sc.rounds):
        spec = FaultSpec.of(dict(rnd.deaths), corrupt=rnd.corrupt, slow=rnd.slow)
        plan = make_coded_plan(sc.p, sc.parity, spec)
        x = rng.normal(size=(sc.p, 4, 4)).astype(np.float32)
        x[list(rnd.masked)] = 0.0                  # BLANK: zero contribution
        observed = x.copy()
        observed[list(rnd.corrupt)] *= 3.0         # inject the SDC
        val, valid, det = coded_allreduce(
            torch.from_numpy(x).to(device), comm, op=sc.op, plan=plan,
            observed=torch.from_numpy(observed).to(device),
        )
        val = val.cpu().numpy()
        valid = valid.cpu().numpy()[: sc.p]
        det = det.cpu().numpy()[: sc.p]
        expect = x.sum(0)      # truth: erased contributions reconstructed
        holders = np.nonzero(valid)[0]
        match = bool(holders.size) and all(
            np.allclose(val[r], expect, rtol=tol, atol=tol) for r in holders
        )
        in_tol = plan.recoverable
        metrics[f"round{i}_survivors"] = Metric(int(valid.sum()))
        metrics[f"round{i}_within_tolerance"] = Metric(in_tol)
        if in_tol:                                 # the guarantee applies
            all_match &= match
            all_survived &= bool(valid.any())
            all_detected &= bool((np.flatnonzero(det) == np.asarray(rnd.corrupt)).all())
        else:                                      # honest degradation
            honest &= not valid.any() and not match
        expect_msgs += plan.message_count()
        expect_bytes += plan.bytes_on_wire(4, 4)
    metrics["values_match"] = Metric(all_match)
    metrics["survived"] = Metric(all_survived)
    metrics["corruption_detected"] = Metric(all_detected)
    metrics["honest_degradation"] = Metric(honest)
    metrics["messages"] = Metric(comm.stats.messages)
    metrics["wire_matches_plan"] = Metric(
        comm.stats.messages == expect_msgs and comm.stats.payload_bytes == expect_bytes)
    metrics["payload_bytes"] = Metric(comm.stats.payload_bytes, unit="B")
    return metrics


def run_collective_scenario(sc: CollectiveScenario, seed: int = 0, *, device=None) -> dict:
    """Run every round; return the metric dict (unprefixed names)."""
    from repro_torch.collective import (
        FaultSpec,
        InstrumentedComm,
        SimComm,
        ft_allreduce,
        ilog2,
        make_plan,
        within_tolerance,
    )

    device = _device(device)
    if sc.scheme == "coded":
        return _run_coded_scenario(sc, seed, device)
    if any(rnd.corrupt or rnd.slow for rnd in sc.rounds):
        raise ValueError(
            f"scenario {sc.name}: corrupt/slow rounds need scheme='coded' "
            "(the butterfly planners ignore both fault kinds by design)"
        )
    rng = np.random.default_rng(seed)
    comm = InstrumentedComm(SimComm(sc.p, device))
    n_steps = ilog2(sc.p)
    metrics: dict[str, Metric] = {}
    all_match = all_survived = True
    for i, rnd in enumerate(sc.rounds):
        spec = FaultSpec.of(dict(rnd.deaths))
        plan = make_plan(sc.variant, sc.p, spec)
        x = rng.normal(size=(sc.p, 4, 4)).astype(np.float32)
        x[list(rnd.masked)] = 0.0                      # BLANK: zero contribution
        val, valid = ft_allreduce(torch.from_numpy(x).to(device), comm, op=sc.op, plan=plan)
        val, valid = val.cpu().numpy(), valid.cpu().numpy()
        expect = x.sum(0)                              # full reduction over P
        holders = np.nonzero(valid)[0]
        match = bool(holders.size) and all(
            np.allclose(val[r], expect, rtol=1e-5, atol=1e-5) for r in holders
        )
        in_tol = within_tolerance(sc.variant, spec, n_steps)
        metrics[f"round{i}_survivors"] = Metric(int(valid.sum()))
        if in_tol:                                     # the guarantee applies
            all_match &= match
            all_survived &= bool(valid.any())
        metrics[f"round{i}_within_tolerance"] = Metric(in_tol)
    metrics["values_match"] = Metric(all_match)
    metrics["survived"] = Metric(all_survived)
    metrics["messages"] = Metric(comm.stats.messages)
    metrics["comm_rounds"] = Metric(comm.stats.rounds)
    metrics["payload_bytes"] = Metric(comm.stats.payload_bytes, unit="B")
    return metrics


def run_blocked_qr_scenario(sc: BlockedQRScenario, seed: int = 0, *, device=None) -> dict:
    """Run the blocked QR under the death schedule; return the metric dict.

    Raises :class:`BenchFailure` when a within-tolerance schedule leaves a
    survivor's R off the dense QR, or when the trailing block is not swept
    exactly once per panel.
    """
    from repro_torch.core import ref
    from repro_torch.kernels import traffic
    from repro_torch.qr import PanelFaultSchedule, QRConfig, factorize

    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((sc.p, sc.m_local, sc.n)).astype(np.float32)
    sched = PanelFaultSchedule.of(
        panel={k: dict(deaths) for k, deaths in sc.panel_deaths},
        update={k: dict(deaths) for k, deaths in sc.update_deaths},
    )
    with traffic.track_traffic() as t:
        res = factorize(blocks, QRConfig(panel_width=sc.panel_width, variant=sc.variant),
                        faults=sched, device=_device(device))
    in_tol = all(rep.within_tolerance for rep in res.reports)
    valid = res.valid.cpu().numpy()
    expect = np.ones(sc.p, dtype=bool)
    for rep in res.reports:
        expect &= rep.plan_r.final_valid
        if rep.plan_w is not None:
            expect &= rep.plan_w.final_valid
    truth = ref.qr_r(blocks.reshape(-1, sc.n).astype(np.float64))
    scale = max(1.0, np.abs(truth).max())
    r = res.r.cpu().numpy()
    holders = np.flatnonzero(valid)
    match = bool(holders.size) and all(
        np.abs(r[i] - truth).max() / scale < 5e-4 for i in holders
    )
    if in_tol and not match:
        raise BenchFailure(
            f"scenario {sc.name}: within-tolerance schedule but survivor R "
            "does not match the dense QR"
        )
    sweeps = t.sweeps_of("panel_cross", "trailing_update")
    if sweeps != res.n_panels:
        raise BenchFailure(
            f"scenario {sc.name}: {sweeps} trailing-block sweeps for "
            f"{res.n_panels} panels — the 1-sweep-per-panel claim failed"
        )
    return {
        "survivors": Metric(int(valid.sum())),
        "survivors_match_plan": Metric(bool((valid == expect).all())),
        "within_tolerance": Metric(in_tol),
        "values_match": Metric(match),
        "recovered": Metric(sum(rep.recovered_r + rep.recovered_w for rep in res.reports)),
        "n_panels": Metric(res.n_panels),
        "trailing_sweeps": Metric(sweeps),
        "sweeps_per_panel": Metric(sweeps / res.n_panels),
    }


def trainer_scenario_run(sc: TrainerScenario, ckpt_dir: str | None = None, *, device=None,
                         cfg=None, seq_len: int = 32, state=None):
    """Drive a small Trainer through the scenario's event schedule and
    return it (its ``fault_stats``, ``events_log``, ``metrics_log``).

    ``cfg`` replaces the scenario's ``smoke(n_layers=...)`` config of
    ``sc.arch`` (e.g. the published widths at that depth), ``seq_len`` the
    reference's 32-token rows, and ``state`` — ``(params, opt_state)`` —
    the trainer's own ``init_state()``.  Checkpoints go under ``ckpt_dir``
    or a temporary directory that is removed after the run.
    """
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.elastic import ReplicaMesh

    cfg = cfg or get_config(sc.arch).smoke(n_layers=sc.n_layers)
    mesh = ReplicaMesh.of((sc.data_width, sc.model_width), ("data", "model"))
    own_dir = ckpt_dir is None
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix=f"bench_{sc.name}_")
    tcfg = TrainerConfig(
        steps=sc.steps, log_every=10**9, ckpt_every=sc.ckpt_every,
        ckpt_dir=ckpt_dir, optimizer=sc.optimizer,
        on_failure=sc.on_failure, buddy_levels=sc.buddy_levels, seed=0,
    )
    dc = DataConfig(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=2 * sc.data_width,
        family=cfg.family,
        enc_frames=cfg.enc_frames if cfg.family == "encdec" else 0,
        d_model=cfg.d_model,
    )
    try:
        tr = Trainer(cfg, tcfg, mesh, dc, device=_device(device))
        tr.run(*(state or ()), fault_schedule=tuple(sc.events))
    finally:
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return tr


def run_trainer_scenario(sc: TrainerScenario, ckpt_dir: str | None = None, *, device=None,
                         **kw) -> dict:
    """Drive a small Trainer through the event schedule
    (:func:`trainer_scenario_run`, which takes ``kw``); the metric dict
    (:func:`trainer_scenario_metrics`).  Raises :class:`BenchFailure` when a
    fault stat misses the scenario's expectation; anything else (I/O
    errors included) propagates."""
    return trainer_scenario_metrics(sc, trainer_scenario_run(sc, ckpt_dir, device=device, **kw))


def trainer_scenario_metrics(sc: TrainerScenario, tr) -> dict:
    """The metric dict of the trainer ``tr`` that ran ``sc``; raises
    :class:`BenchFailure` when a fault stat misses its expectation."""
    losses = [m["loss"] for m in tr.metrics_log]
    metrics: dict[str, Metric] = {
        "completed_final_step": Metric(int(tr.metrics_log[-1]["step"])),
        "loss_finite": Metric(bool(np.isfinite(losses).all())),
        "final_replicas": Metric(int(tr.n_replicas)),
    }
    for key, want in sc.expect.items():
        got = int(tr.fault_stats[key])
        metrics[f"stat_{key}"] = Metric(got)
        if got != want:
            raise BenchFailure(
                f"scenario {sc.name}: fault_stats[{key!r}] = {got}, "
                f"schedule expects {want} (events: "
                + "; ".join(tr.events_log[-6:]) + ")"
            )
    return metrics


def run_scenario(sc, **kw) -> dict:
    if sc.kind == "collective":
        return run_collective_scenario(sc, **kw)
    if sc.kind == "blocked":
        return run_blocked_qr_scenario(sc, **kw)
    return run_trainer_scenario(sc, **kw)


# ---------------------------------------------------------------------------
# The stock sweep (the reference's, in its order)
# ---------------------------------------------------------------------------

SCENARIOS = (
    # Correlated: one 4-rank failure domain dies at once at the entry of
    # exchange 3, where 2^3 copies of every intermediate exist.
    CollectiveScenario(
        name="correlated_block_wipe", p=16, variant="replace",
        rounds=(ReduceRound(deaths=((8, 3), (9, 3), (10, 3), (11, 3))),),
        description="ranks 8-11 (one failure domain) die at entry of "
                    "exchange 3; replace reroutes, 12 survivors",
    ),
    # Cascading: failures at successive exchanges; Self-Healing respawns
    # between steps so every rank ends holding the result.
    CollectiveScenario(
        name="cascading_failures", p=16, variant="selfhealing",
        rounds=(ReduceRound(deaths=((1, 1), (6, 2), (9, 2), (12, 3))),),
        description="1 death at step 1, two at step 2, one at step 3 — "
                    "within the per-step 2^s−1 budget at every step",
    ),
    # BLANK under repeat: successive reductions with a growing masked set
    # whose ranks also die mid-reduce.
    CollectiveScenario(
        name="blank_under_repeat", p=8, variant="redundant",
        rounds=(
            ReduceRound(),
            ReduceRound(masked=(2,), deaths=((2, 2),)),
            ReduceRound(masked=(2, 5), deaths=((5, 1),)),
        ),
        description="repeated reductions; masked replicas contribute "
                    "zero, and also die mid-reduce within tolerance",
    ),
    # Straggler reconstruction: two slow ranks are left out of the coded
    # gather and decoded from parity, not awaited.
    CollectiveScenario(
        name="straggler_reconstruction", p=8, variant="redundant",
        scheme="coded", parity=2,
        rounds=(ReduceRound(slow=(2, 5)),),
        description="ranks 2 and 5 straggle; the coded plan excludes "
                    "them from the gather and decodes both from the 2 "
                    "parity lanes — no waiting, values exact",
    ),
    # Silent corruption detected: a rank's observed payload is perturbed;
    # the coded plan reconstructs the true contribution and flags the rank.
    CollectiveScenario(
        name="silent_corruption_detected", p=8, variant="redundant",
        scheme="coded", parity=2,
        rounds=(ReduceRound(corrupt=(3,)), ReduceRound(corrupt=(1, 6))),
        description="SDC injected on ranks 3, then 1 and 6; detection "
                    "flags exactly the corrupted ranks and the result "
                    "matches the uncorrupted truth",
    ),
    # Over-parity death: more deaths than parity lanes degrade honestly; a
    # follow-up round within budget succeeds.
    CollectiveScenario(
        name="over_parity_death", p=8, variant="redundant",
        scheme="coded", parity=2,
        rounds=(
            ReduceRound(deaths=((1, 0), (4, 0), (6, 1))),
            ReduceRound(deaths=((1, 0), (4, 0))),
        ),
        description="3 deaths exceed the c=2 erasure budget (round 0: "
                    "all-invalid, no garbage); 2 deaths decode fine "
                    "(round 1)",
    ),
    # Fail during rebuild: disk-rollback REBUILD (no buddy store), and a
    # second replica fails while the first rollback is still replaying.
    TrainerScenario(
        name="fail_during_rebuild", on_failure="rebuild",
        buddy_levels=0, steps=10, ckpt_every=3,
        events=(
            FaultEvent(step=5, kind="fail", replica=0),
            FaultEvent(step=5, kind="fail", replica=1),
        ),
        expect={"failures": 2, "rollbacks": 2},
        description="replica 0 dies at step 5 → rollback to ckpt 3; "
                    "replica 1 dies when the replay re-reaches step 5",
    ),
    # Buddy-pair wipe: both members of an XOR buddy pair die in the same
    # step — the first recovers diskless from its buddy, the second finds
    # its only replica gone and falls back to the disk rollback.
    TrainerScenario(
        name="buddy_pair_wipe", on_failure="rebuild",
        buddy_levels=1, steps=8, ckpt_every=3,
        events=(
            FaultEvent(step=5, kind="fail", replica=0),
            FaultEvent(step=5, kind="fail", replica=1),
        ),
        expect={"failures": 2, "buddy_restores": 1, "rollbacks": 1},
        description="replicas 0 and 1 (level-1 buddies) die together; "
                    "first recovers diskless, second needs the disk",
    ),
    # Blocked QR, deaths during panel 1's reduction, rerouted by Replace.
    BlockedQRScenario(
        name="panel_death_midsweep", p=8, variant="replace",
        m_local=48, n=20, panel_width=6,
        panel_deaths=((1, ((3, 1), (6, 2))),),
        description="ranks 3 and 6 die at exchanges 1 and 2 of panel 1's "
                    "TSQR; replace reroutes, R exact on all 6 survivors",
    ),
    # Blocked QR, a death during panel 0's cross-product reduction.
    BlockedQRScenario(
        name="death_during_trailing_update", p=8, variant="redundant",
        m_local=48, n=20, panel_width=6,
        update_deaths=((0, ((5, 1),)),),
        description="rank 5 dies during panel 0's trailing-update "
                    "reduction; its step-1 coset invalidates, replica "
                    "fetch re-arms the pipeline",
    ),
    # Blocked QR, a fresh death in each of the first three panels.
    BlockedQRScenario(
        name="cascading_panels", p=8, variant="selfhealing",
        m_local=48, n=20, panel_width=6,
        panel_deaths=((0, ((1, 1),)), (1, ((6, 2),)), (2, ((3, 1),))),
        description="one death per panel across panels 0-2, each within "
                    "the per-step budget; selfhealing keeps all 8 valid",
    ),
    # SHRINK then REBUILD: elastic round trip through the mesh layer.
    TrainerScenario(
        name="shrink_then_rebuild", on_failure="shrink",
        steps=8, ckpt_every=0,
        events=(
            FaultEvent(step=3, kind="fail", replica=1),
            FaultEvent(step=6, kind="rejoin"),
        ),
        expect={"failures": 1, "shrinks": 1, "rejoins": 1},
        description="lose a replica at step 3 (mesh 4→2), replacement "
                    "hardware rejoins at step 6 (mesh 2→4)",
    ),
)


def get_scenarios() -> tuple:
    """The stock sweep: the reference's collective, trainer and blocked
    scenarios, in its order."""
    return SCENARIOS


def case(include_trainer: bool = True, seed: int = 0, device=None):
    """Every stock scenario (the trainer's unless ``include_trainer`` is
    false), its metrics prefixed with its name, and the count run."""
    metrics: dict[str, Metric] = {}
    n_run = 0
    for sc in get_scenarios():
        if sc.kind == "trainer" and not include_trainer:
            continue
        kw = {"seed": seed} if sc.kind in ("collective", "blocked") else {}
        sub = run_scenario(sc, device=device, **kw)
        n_run += 1
        for k, m in sub.items():
            metrics[f"{sc.name}.{k}"] = m
    metrics["n_scenarios_run"] = Metric(n_run, gate="hard", direction="higher")
    return metrics


bench_case(
    "fault_scenarios",
    tags=("robustness", "scenarios"),
    params={
        "smoke": {"include_trainer": True, "seed": 0},
        "full": {"include_trainer": True, "seed": 0},
    },
)(case)
