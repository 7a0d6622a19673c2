"""Fault-tolerant training runtime, the port of :mod:`repro.runtime.trainer`.

Exposes the paper's three failure semantics at training-step granularity:

  * ``rebuild``  (Self-Healing / REBUILD): the lost replica's state is
    restored — from the in-memory buddy store when a replica exists
    (diskless path, zero I/O), else from the latest disk checkpoint — and
    the step is retried at full width.
  * ``shrink``   (Replace / SHRINK): the replica mesh is rebuilt without the
    lost replica and the run continues at reduced width (elastic scaling).
  * ``blank``    (Redundant / BLANK): the dead replica's rows are masked
    out of the loss (weight 0) and the gradient rescales over survivors;
    width is restored when the replica returns.  With >1 replicas the
    gradient combine itself runs through
    :func:`~repro_torch.collective.engine.ft_allreduce` (redundant
    butterfly, ``sum`` combiner) over the explicit replica axis, so the
    reduction inherits the paper's 2^s − 1 mid-reduce tolerance.

The replicas are simulated on one device (a
:class:`~repro_torch.collective.comm.SimComm` whose rank axis is the
replica axis), and the mesh is a
:class:`~repro_torch.runtime.elastic.ReplicaMesh` topology; a model axis
wider than 1 (tensor parallelism) waits for ROADMAP A.3e.  The step runs
eagerly; one step is built per mesh equivalence class and counts the
reference's jit trace (``dispatch.note_trace("train_step")``) on its first
call for each input signature, and every call counts one
``note_dispatch("train_step")``.

Failures are injected via a schedule of :class:`FaultEvent`: the runtime
consumes simulated health transitions where a real deployment consumes its
health service.  Straggler mitigation: a step-time EMA flags outliers; in
``blank`` mode flagged replicas are masked for the step (drop-straggler
gradient), otherwise they are only logged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.replicated import BuddyStore
from repro_torch.collective import SimComm, ft_allreduce, make_plan
from repro_torch.collective.comm import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.kernels import dispatch as _dispatch
from repro_torch.models import api
from repro_torch.optim import adamw, lowrank, orthosgd, powersgd
from repro_torch.optim._tree import leaves, map_params, unflatten

from .elastic import ReplicaMesh, mesh_fingerprint, rebuild_mesh, shrink_mesh

__all__ = [
    "TrainerConfig",
    "FaultEvent",
    "Trainer",
    "ft_replica_grad",
    "mask_replica_tree",
    "replica_grads",
    "value_and_grad",
]


def value_and_grad(fn, params, *args):
    """``(fn(params, *args), d fn / d params)`` with the gradient a tree
    like ``params`` (``jax.value_and_grad``): the leaves are differentiated
    through detached copies that share their storage, so the caller's
    tensors are left as they are.  An unused leaf gets a zero gradient."""
    flat = leaves(params)
    with torch.enable_grad():
        req = [t.detach().requires_grad_(True) for t in flat]
        value = fn(unflatten(params, req), *args)
        grads = torch.autograd.grad(value, req, allow_unused=True, materialize_grads=True)
    return value.detach(), unflatten(params, list(grads))


def _rows(x, n: int, i: int):
    """Slice ``i`` of ``n`` contiguous slices along the leading axis (the
    reference's ``x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]``)."""
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]


def replica_grads(loss_fn, params, batch, n_replicas: int):
    """Per-replica losses and gradients over the trainer's replica layout.

    ``batch`` rows are split into ``n_replicas`` contiguous slices and each
    slice's gradient is taken in turn; liveness derives from the
    ``loss_weight`` mask (an all-zero slice — a failed or dropped-straggler
    replica masked by ``Trainer._mask_for`` — is dead).  Returns
    ``(losses (R,), grads with leading (R,) axis, live (R,) bool,
    n_live f32 ≥ 1)``: the raw material both the BLANK gradient combine
    (:func:`ft_replica_grad`) and the in-step PowerSGD round
    (:func:`repro_torch.optim.powersgd.compress_mean_grad`) reduce over.
    """
    losses, stacked = [], None
    for r in range(n_replicas):
        loss, grads = value_and_grad(
            loss_fn, params, {k: _rows(v, n_replicas, r) for k, v in batch.items()})
        flat = leaves(grads)
        if stacked is None:
            stacked = [g.new_empty((n_replicas, *g.shape)) for g in flat]
        for s, g in zip(stacked, flat):
            s[r].copy_(g)
        del grads, flat
        losses.append(loss)
    live = batch["loss_weight"].reshape(n_replicas, -1).sum(-1) > 0
    n_live = torch.clamp_min(live.sum(), 1).to(torch.float32)
    return torch.stack(losses), unflatten(params, stacked), live, n_live


def mask_replica_tree(tree, live, n_replicas: int):
    """Zero every dead replica's slice of each leading-(R,) leaf."""

    def mask(g):
        return g * live.reshape((n_replicas,) + (1,) * (g.ndim - 1)).to(g.dtype)

    return map_params(mask, tree)


def _live_mean(losses, live, n_live):
    return torch.where(live, losses, 0.0).sum() / n_live


def ft_replica_grad(loss_fn, params, batch, n_replicas: int, fault_spec=None):
    """BLANK-semantics gradient combine over an explicit replica axis.

    ``batch`` rows are split into ``n_replicas`` contiguous slices (the
    trainer's replica layout), per-replica gradients are taken, dead
    replicas — an all-zero ``loss_weight`` slice — are zeroed, and the
    survivor gradients are combined with
    :func:`~repro_torch.collective.engine.ft_allreduce` (redundant
    butterfly, ``sum`` combiner) on a
    :class:`~repro_torch.collective.comm.SimComm` on the parameters'
    device whose rank axis is the replica axis.  ``fault_spec`` injects
    mid-reduce rank failures.

    Returns ``(loss, grads)``, both means over *live* replicas; the
    gradient leaves are float32 (the reference's promotion of a leaf
    divided by the f32 live count).  This materializes R per-replica
    gradient trees (R× the fused path's gradient memory); set
    ``TrainerConfig.ft_grad_allreduce=False`` to keep the fused path.
    """
    # The combined gradient must be read from a slot the planner certifies
    # valid (slot 0 is not guaranteed to survive an in-tolerance fault).
    plan = make_plan("redundant", n_replicas, fault_spec)
    if not plan.final_valid.any():
        raise ValueError(
            "fault_spec exceeds the butterfly's tolerance: no replica slot "
            f"holds the combined gradient (final_valid={plan.final_valid})"
        )
    slot = int(np.argmax(plan.final_valid))

    losses, grads, live, n_live = replica_grads(loss_fn, params, batch, n_replicas)
    masked = leaves(mask_replica_tree(grads, live, n_replicas))
    del grads
    summed, _ = ft_allreduce(masked, SimComm(n_replicas, live.device), op="sum", plan=plan)
    del masked
    grads = unflatten(params, [s[slot].float() / n_live for s in summed])
    return _live_mean(losses, live, n_live), grads


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    step: int
    kind: str              # "fail" | "recover" | "straggle" | "rejoin"
    replica: int = 0       # data-parallel replica index (unused for rejoin)
    duration: int = 1      # steps (straggle)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    steps: int = 50
    log_every: int = 10
    ckpt_every: int = 25
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_keep: int = 2
    microbatches: int = 1
    on_failure: str = "blank"          # blank | shrink | rebuild
    optimizer: str = "adamw"           # adamw | powersgd | orthosgd | lowrank
    lr: float = 3e-4
    # PowerSGD / low-rank compression rank, and the shard count for the
    # in-step fault-tolerant CQR2 (orthosgd/lowrank Gram butterflies).
    opt_rank: int = 8
    qr_shards: int = 4
    # Route the optimizer's in-step collectives (PowerSGD reductions +
    # TSQR, CQR2 Gram sums) through the fault-tolerant butterfly; False is
    # the dense parity baseline (plain sums, plain CQR2).
    ft_in_step: bool = True
    straggler_factor: float = 3.0
    drop_stragglers: bool = True
    buddy_levels: int = 1              # 2^levels in-memory replicas
    # BLANK mode: combine gradients with the fault-tolerant butterfly
    # (ft_replica_grad).  Costs R× peak gradient memory against the fused
    # path — disable to keep the fused path.
    ft_grad_allreduce: bool = True
    seed: int = 0


def _signature(tree) -> tuple:
    """Shapes and dtypes of a tree's tensors: what a jit retraces on."""
    return tuple((tuple(t.shape), t.dtype) for t in leaves(tree))


class Trainer:
    def __init__(self, model_cfg, tcfg: TrainerConfig, mesh: ReplicaMesh, data_cfg: DataConfig,
                 opt_cfg: adamw.AdamWConfig | None = None, *, device=None):
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        # warmup must fit inside the run: smoke/short runs would otherwise
        # never leave the ramp (default warmup 100 ≫ a 10-step run).
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(
            lr=tcfg.lr, total_steps=tcfg.steps,
            warmup=min(100, max(1, tcfg.steps // 10)),
        )
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.n_replicas = self._mesh_replicas(mesh)
        # buddy_levels=0 disables the diskless store entirely (forces the
        # disk-rollback REBUILD path — fault-scenario sweeps rely on this).
        self.buddies = BuddyStore(max(2, 1 << (self.n_replicas - 1).bit_length())) \
            if self.n_replicas > 1 and tcfg.buddy_levels > 0 else None
        self.alive = np.ones(self.n_replicas, dtype=bool)
        self.straggling = np.zeros(self.n_replicas, dtype=np.int64)
        self.metrics_log: list[dict] = []
        self.events_log: list[str] = []
        # Structured counters consumed by the fault-scenario benchmarks
        # (repro_torch.bench.scenarios) — the machine-readable twin of
        # events_log.
        self.fault_stats: dict[str, int] = {
            "failures": 0, "recoveries": 0, "straggles": 0, "rollbacks": 0,
            "buddy_restores": 0, "shrinks": 0, "rejoins": 0, "masked_steps": 0,
        }
        # REBUILD-to-full-width target: the topology we started with.
        self._template_mesh = mesh
        # One step per mesh equivalence class (mesh_fingerprint): an elastic
        # shrink→rebuild cycle ends on a mesh fingerprinting identically to
        # the template, so _build restores the original step — zero new
        # traces.
        self._step_cache: dict = {}
        self._build(mesh)

    # ------------------------------------------------------------------
    @staticmethod
    def _mesh_replicas(mesh: ReplicaMesh) -> int:
        n = 1
        for a in ("pod", "data"):
            if a in mesh.axis_names:
                n *= mesh.size(a)
        return n

    def _build(self, mesh: ReplicaMesh):
        """(Re)create the step for the current mesh, cached per mesh
        equivalence class: a rebuilt mesh over the same slots restores the
        step built before instead of building (and tracing) a new one."""
        if "model" in mesh.axis_names and mesh.size("model") > 1:
            raise NotImplementedError(
                f"a model axis of {mesh.size('model')} is a tensor-parallel mesh, which "
                "waits for the model axis over DistComm (ROADMAP A.3e); the replicas of one "
                "card are the data axis"
            )
        self.mesh = mesh
        fp = mesh_fingerprint(mesh)
        cached = self._step_cache.get(fp)
        if cached is not None:
            self.step_fn, self.ft_grad_allreduce, self._opt_init = cached
            return
        cfg, tcfg, opt_cfg = self.model_cfg, self.tcfg, self.opt_cfg
        n_rep = self.n_replicas
        # An explicit replica axis is available when the batch splits into
        # power-of-two contiguous replica slices.  (vlm batches carry a
        # non-leading batch axis and stay on the fused path.)
        use_rep = (
            tcfg.ft_grad_allreduce
            and n_rep > 1
            and (n_rep & (n_rep - 1)) == 0
            and cfg.family != "vlm"
            # per-replica slices are microbatched by loss_over_micro; only
            # the trivial split is guaranteed divisible for any batch shape
            and tcfg.microbatches == 1
        )
        # BLANK semantics: the gradient combine itself routes through the
        # fault-tolerant butterfly.
        use_ft = use_rep and tcfg.on_failure == "blank"
        self.ft_grad_allreduce = use_ft
        if use_ft:
            self.events_log.append(
                f"gradient all-reduce: ft_allreduce over {n_rep} replicas"
            )

        def loss_over_micro(p, b):
            if tcfg.microbatches == 1:
                return api.loss_fn(p, b, cfg)
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(tcfg.microbatches):
                mb = {k: _rows(v, tcfg.microbatches, i) for k, v in b.items()}
                total = total + api.loss_fn(p, mb, cfg) / tcfg.microbatches
            return total

        def combined_grads(params, batch):
            if use_ft:
                return ft_replica_grad(loss_over_micro, params, batch, n_rep)
            return value_and_grad(loss_over_micro, params, batch)

        step_fn, self._opt_init = self._make_optimizer_step(
            tcfg, opt_cfg, n_rep, use_rep, combined_grads, loss_over_micro)
        signatures: set = set()

        def step(params, opt_state, batch):
            _dispatch.note_dispatch("train_step")
            sig = _signature((params, opt_state, batch))
            if sig not in signatures:                # the reference's jit trace
                signatures.add(sig)
                _dispatch.note_trace("train_step")
            with torch.no_grad():
                return step_fn(params, opt_state, batch)

        self.step_fn = step
        self._step_cache[fp] = (self.step_fn, self.ft_grad_allreduce, self._opt_init)

    # ------------------------------------------------------------------
    def _make_optimizer_step(self, tcfg, opt_cfg, n_rep, use_rep, combined_grads,
                             loss_over_micro):
        """Per-optimizer step body + state init."""
        opt = tcfg.optimizer
        device = self.device

        if opt == "adamw":

            def step_fn(params, opt_state, batch):
                loss, grads = combined_grads(params, batch)
                new_p, new_o, om = adamw.update(opt_cfg, params, grads, opt_state)
                return new_p, new_o, {"loss": loss, **om}

            return step_fn, adamw.init

        shards = tcfg.qr_shards if tcfg.ft_in_step else 0

        if opt == "orthosgd":
            ocfg = orthosgd.OrthoSGDConfig(lr=tcfg.lr, ft_shards=shards)

            def step_fn(params, opt_state, batch):
                loss, grads = combined_grads(params, batch)
                new_p, new_o = orthosgd.update(ocfg, params, grads, opt_state)
                om = {"grad_norm": adamw.global_norm(grads),
                      "lr": torch.tensor(ocfg.lr, dtype=torch.float32)}
                return new_p, new_o, {"loss": loss, **om}

            return step_fn, orthosgd.init

        if opt == "lowrank":
            lcfg = lowrank.LowRankConfig(
                lr=tcfg.lr, rank=tcfg.opt_rank,
                min_dim=max(2 * tcfg.opt_rank, 16), ft_shards=shards,
            )

            def step_fn(params, opt_state, batch):
                loss, grads = combined_grads(params, batch)
                new_p, new_o = lowrank.update(lcfg, params, grads, opt_state)
                om = {"grad_norm": adamw.global_norm(grads),
                      "lr": torch.tensor(lcfg.lr, dtype=torch.float32)}
                return new_p, new_o, {"loss": loss, **om}

            return step_fn, lambda params: lowrank.init(params, cfg=lcfg)

        if opt != "powersgd":
            raise ValueError(f"unknown optimizer {opt!r}")

        pcfg = powersgd.PowerSGDConfig(rank=tcfg.opt_rank, error_feedback=False)
        ft = tcfg.ft_in_step and use_rep
        comm = SimComm(n_rep, device) if ft else None
        plan = make_plan(pcfg.variant, n_rep, None) if ft else None
        slot = int(np.argmax(plan.final_valid)) if ft else 0

        def eligible(shape):
            return len(shape) == 2 and min(shape) > pcfg.rank

        def step_fn(params, opt_state, batch):
            if use_rep:
                losses, g_rep, live, n_live = replica_grads(
                    loss_over_micro, params, batch, n_rep
                )
                g_rep = mask_replica_tree(g_rep, live, n_rep)
                loss = _live_mean(losses, live, n_live)
            else:
                loss, g = value_and_grad(loss_over_micro, params, batch)
                g_rep = map_params(lambda x: x[None], g)
                n_live = torch.tensor(1.0, dtype=torch.float32, device=device)
            flat = leaves(g_rep)
            qs = opt_state["q"]
            ghat: list = [None] * len(flat)
            new_q = list(qs)
            rest_idx = []
            for i, gi in enumerate(flat):
                if eligible(gi.shape[1:]):
                    ghat[i], new_q[i] = powersgd.compress_mean_grad(
                        gi, qs[i], cfg=pcfg, comm=comm, plan=plan,
                        n_live=n_live, ft=ft,
                    )
                else:
                    rest_idx.append(i)
            # every uncompressed leaf rides ONE butterfly (tree payload)
            if rest_idx:
                rest = [flat[i] for i in rest_idx]
                if ft:
                    summed, _ = ft_allreduce(rest, comm, op="sum", plan=plan)
                    rest_mean = [s[slot].float() / n_live for s in summed]
                else:
                    rest_mean = [x.sum(0).float() / n_live for x in rest]
                for i, gm in zip(rest_idx, rest_mean):
                    ghat[i] = gm
            grads = unflatten(params, ghat)
            new_p, new_inner, om = adamw.update(
                opt_cfg, params, grads, opt_state["inner"]
            )
            return new_p, {"inner": new_inner, "q": tuple(new_q)}, \
                {"loss": loss, **om}

        seed, rank = tcfg.seed, pcfg.rank

        def opt_init(params):
            # the start bases are drawn on the CPU and moved, so every
            # device starts from the same bits
            gen = torch.Generator().manual_seed(seed)
            qs = tuple(
                torch.randn((p.shape[1], rank), generator=gen, dtype=torch.float32).to(p.device)
                if eligible(p.shape)
                else torch.zeros((0,), dtype=torch.float32, device=p.device)
                for p in leaves(params)
            )
            return {"inner": adamw.init(params), "q": qs}

        return step_fn, opt_init

    # ------------------------------------------------------------------
    def init_state(self, generator=None):
        """Parameters drawn from ``generator`` (a ``torch.Generator`` on
        the trainer's device, or an int seed; default ``tcfg.seed``) and
        the optimizer's state for them."""
        gen = self.tcfg.seed if generator is None else generator
        params = api.init(gen, self.model_cfg, self.device)
        return params, self._opt_init(params)

    # ------------------------------------------------------------------
    def _mask_for(self, rows: int) -> np.ndarray:
        """Per-row loss weight from replica health (BLANK semantics)."""
        w = np.ones(rows, np.float32)
        per = rows // self.n_replicas
        dead = ~self.alive
        if self.tcfg.drop_stragglers:
            dead = dead | (self.straggling > 0)
        if dead.any():
            self.fault_stats["masked_steps"] += 1
        for r in np.nonzero(dead)[0]:
            w[r * per : (r + 1) * per] = 0.0
        alive_frac = max(w.mean(), 1e-6)
        return w / alive_frac

    def _device_batch(self, host_batch):
        """The host batch (numpy arrays, ``SyntheticCorpus.host_batch``)
        with the health mask's ``loss_weight``, as tensors on the trainer's
        device."""
        rows = host_batch["tokens"].shape[0]
        hb = dict(host_batch, loss_weight=self._mask_for(rows))
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in hb.items()}

    # ------------------------------------------------------------------
    def run(self, params=None, opt_state=None, *, start_step: int = 0,
            fault_schedule: tuple[FaultEvent, ...] = (),
            on_step: Callable | None = None):
        """Train from ``params`` and ``opt_state`` through ``tcfg.steps``
        under the fault schedule; returns the final state.  Each step's
        inputs are freed once the next state exists, unless the caller holds
        them (the reference's step donates its inputs): with
        ``params=None`` the run draws :meth:`init_state` itself, so no
        caller holds the initial state across the run."""
        if params is None:
            params, opt_state = self.init_state()
        corpus = SyntheticCorpus(self.data_cfg, self.device)
        events = sorted(fault_schedule, key=lambda e: e.step)
        fired: set[int] = set()
        ema = None
        step = start_step
        while step < self.tcfg.steps:
            # --- consume health transitions for this step (once each:
            # after a REBUILD rollback the step counter passes the event's
            # step again — re-firing it would loop forever) ---------------
            for i, ev in enumerate(events):
                if ev.step == step and i not in fired:
                    fired.add(i)
                    params, opt_state, step = self._handle_event(
                        ev, params, opt_state, step
                    )
            t0 = time.perf_counter()
            batch = self._device_batch(corpus.host_batch(step))
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            # --- straggler detector --------------------------------------
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            slow = dt > self.tcfg.straggler_factor * ema
            if slow:
                self.events_log.append(f"step {step}: straggler ({dt:.3f}s vs {ema:.3f}s)")
            self.straggling = np.maximum(self.straggling - 1, 0)
            metrics.update(step=step, wall=dt)
            self.metrics_log.append(metrics)
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps - 1:
                print(f"[train] step={step} loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} wall={dt:.2f}s")
            if self.tcfg.ckpt_every and step and step % self.tcfg.ckpt_every == 0:
                self._checkpoint(step, params, opt_state)
            if on_step:
                on_step(step, params, metrics)
            step += 1
        self.ckpt.wait()
        return params, opt_state

    # ------------------------------------------------------------------
    def _checkpoint(self, step, params, opt_state):
        self.ckpt.save(step, {"params": params, "opt": opt_state},
                       meta={"arch": self.model_cfg.name}, block=False)
        if self.buddies is not None:
            # Host-simulated diskless copy: one logical shard per replica.
            shards = {
                r: {"step": step}
                for r in range(self.n_replicas) if self.alive[r]
            }
            self.buddies.checkpoint(step, shards, levels=self.tcfg.buddy_levels)
        self.events_log.append(f"step {step}: checkpoint")

    def _handle_event(self, ev: FaultEvent, params, opt_state, step):
        if ev.kind == "straggle":
            self.straggling[ev.replica] = ev.duration
            self.fault_stats["straggles"] += 1
            self.events_log.append(f"step {step}: replica {ev.replica} straggling")
            return params, opt_state, step
        if ev.kind == "recover":
            self.alive[ev.replica] = True
            self.fault_stats["recoveries"] += 1
            if self.buddies is not None:
                self.buddies.respawn(ev.replica)
            self.events_log.append(f"step {step}: replica {ev.replica} recovered")
            return params, opt_state, step
        if ev.kind == "rejoin":
            params, opt_state = self._rejoin(params, opt_state)
            return params, opt_state, step
        assert ev.kind == "fail"
        self.alive[ev.replica] = False
        self.fault_stats["failures"] += 1
        if self.buddies is not None:
            self.buddies.fail(ev.replica)
        mode = self.tcfg.on_failure
        self.events_log.append(
            f"step {step}: replica {ev.replica} FAILED → {mode}"
        )
        if mode == "blank":
            return params, opt_state, step          # masked out by _mask_for
        if mode == "rebuild":
            # Diskless first: a live buddy replica of the lost shard means
            # no rollback at all (the paper's Self-Healing semantics);
            # otherwise restore the latest disk checkpoint.
            restored = None
            if self.buddies is not None:
                try:
                    ck_step, _ = self.buddies.recover(ev.replica)
                    restored = step  # in-memory state is current: no rollback
                    self.fault_stats["buddy_restores"] += 1
                    self.events_log.append(
                        f"step {step}: replica {ev.replica} restored from buddy "
                        f"(ckpt step {ck_step}, no rollback)"
                    )
                except KeyError:
                    pass
            # Drain the async save thread BEFORE probing for a checkpoint: a
            # failure arriving a step or two after a non-blocking save must
            # not race the manifest write and silently skip the rollback.
            if restored is None:
                self.ckpt.wait()
            if restored is None and self.ckpt.latest_step() is not None:
                # each leaf comes back on its template's device (the step
                # counter on the CPU)
                state, meta = self.ckpt.restore({"params": params, "opt": opt_state})
                params, opt_state = state["params"], state["opt"]
                step = int(meta["step"]) + 1
                self.fault_stats["rollbacks"] += 1
                self.events_log.append(
                    f"rollback to checkpoint step {meta['step']}"
                )
            self.alive[ev.replica] = True            # respawned
            if self.buddies is not None:
                self.buddies.respawn(ev.replica)
            return params, opt_state, step
        if mode == "shrink":
            params, opt_state = self._shrink(params, opt_state, ev.replica)
            return params, opt_state, step
        raise ValueError(mode)

    def _shrink(self, params, opt_state, dead_replica: int):
        """Elastic SHRINK: rebuild the mesh without the dead replica."""
        # shrink_mesh keeps the leading data-axis slice, so rotate the dead
        # replica to the tail first — the surviving mesh must not contain
        # the failed replica.
        mesh = self.mesh
        if "data" in mesh.axis_names:
            ax = mesh.axis_names.index("data")
            d = mesh.shape[ax]
            if 0 <= dead_replica < d:
                order = [i for i in range(d) if i != dead_replica] + [dead_replica]
                mesh = ReplicaMesh(mesh.axis_names, np.take(mesh.ids, order, axis=ax))
        new_mesh = shrink_mesh(mesh, drop_replicas=1)
        if new_mesh is None:
            self.events_log.append("shrink impossible (data axis exhausted) — blanking")
            return params, opt_state
        params, opt_state = self._remesh(params, opt_state, new_mesh)
        self.fault_stats["shrinks"] += 1
        self.events_log.append(
            f"elastic shrink → mesh {dict(zip(new_mesh.axis_names, new_mesh.shape))}"
        )
        return params, opt_state

    def _rejoin(self, params, opt_state):
        """Elastic REBUILD: replacement replicas are back — re-instantiate
        the original template topology (the inverse of :meth:`_shrink`; a
        ``"rejoin"`` :class:`FaultEvent`)."""
        full = rebuild_mesh(self._template_mesh)
        if full.shape == self.mesh.shape:
            self.events_log.append("rejoin: already at full width — no-op")
            return params, opt_state
        params, opt_state = self._remesh(params, opt_state, full)
        self.fault_stats["rejoins"] += 1
        self.events_log.append(
            f"elastic rebuild → mesh {dict(zip(full.axis_names, full.shape))}"
        )
        return params, opt_state

    def _remesh(self, params, opt_state, new_mesh: ReplicaMesh):
        """Switch to ``new_mesh``'s step.  The replicas share one device, so
        the state stays where it is (the reference reshards it)."""
        self.n_replicas = self._mesh_replicas(new_mesh)
        self.alive = np.ones(self.n_replicas, dtype=bool)
        self.straggling = np.zeros(self.n_replicas, dtype=np.int64)
        self._build(new_mesh)
        return params, opt_state
