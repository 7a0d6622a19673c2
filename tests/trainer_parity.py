"""Shared helpers of the trainer parity tests: run the JAX package's
``Trainer`` and the port's on the same case, the port started from the
reference's initial state, and compare what the two runs leave behind.

A :class:`Case` is one training run: the architecture at ``smoke()``
sizes, the replica count, the data shape, the ``TrainerConfig`` fields and
the fault schedule.  :func:`reference_run` runs it through the reference
and returns a plain dict of numpy arrays, lists and ints (picklable, so a
subprocess with several JAX devices can compute it); :func:`port_run` runs
it through the port on the CPU from the reference's initial state;
:func:`assert_same_run` holds one against the other.

The reference draws its parameters and PowerSGD's bases with
``jax.random``, which the port cannot reproduce, so the port is handed the
reference's initial state (``params_from_reference``,
``state_from_reference``), saved before ``run`` because the reference's
jitted step donates its buffers.  Its low-rank refresh draws Ω from
``jax.random`` too; :func:`reference_sketch` hands the port that Ω.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

import jax_reference  # noqa: F401  (before any repro import)
import jax
import jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs.base import get_config as jget
from repro.data.pipeline import DataConfig as JDataConfig
from repro.kernels import dispatch as jdispatch
from repro.runtime import trainer as jtrainer

import torch
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import params_from_reference
from repro_torch.optim import lowrank, state_from_reference
from repro_torch.optim._tree import leaves
from repro_torch.runtime import trainer as ttrainer
from repro_torch.runtime.elastic import ReplicaMesh

# Losses of the two packages, relative: the reference's own tolerance
# between two of its runs (tests/test_trainer.py::
# test_checkpoint_restart_reproduces_data).  Both run f32 products on the
# CPU in their own summation orders (~3e-7 read at smoke sizes).
LOSS_RTOL = 1e-4
# Final parameters: the reference's optimizer tolerance (tests/test_optim.py,
# rtol = atol = 2e-4).  OrthoSGD's CholeskyQR2 of the momentum carries the
# two sides' rounding furthest: 3.9e-4 of max|param| (4e-5 absolute) after
# three steps; AdamW's and PowerSGD's read ~1e-6.
PARAM_TOL = 2e-4
# "step N: straggler (…s vs …s)" comes from the wall clock (a first step,
# or a rebuild after a remesh, is slow on either side), so the events logs
# are compared with those lines taken out; every other line must be equal.
STRAGGLER = re.compile(r"step \d+: straggler \(")


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str = "olmo-1b"
    n_layers: int = 2
    data: int = 1
    seq_len: int = 32
    global_batch: int = 8
    tcfg: tuple = ()                   # TrainerConfig fields, (name, value) pairs
    events: tuple = ()                 # (step, kind, replica, duration)
    no_buddies: bool = False           # drop the buddy store (disk rollback)

    def trainer_kw(self, ckpt_dir: str) -> dict:
        kw = dict(log_every=100, ckpt_dir=ckpt_dir)
        kw.update(dict(self.tcfg))
        return kw


def without_stragglers(log: list[str]) -> list[str]:
    return [e for e in log if not STRAGGLER.match(e)]


def _data_cfg(make, cfg, case: Case):
    """The launcher's data config: Whisper's batches carry ``enc_frames``
    frames of ``d_model``."""
    return make(vocab=cfg.vocab, seq_len=case.seq_len, global_batch=case.global_batch,
                family=cfg.family, d_model=cfg.d_model,
                enc_frames=cfg.enc_frames if cfg.family == "encdec" else 0)


def copy_tree(tree):
    """numpy copies of a tree of arrays (before the jitted step donates
    them)."""
    return jax.tree.map(np.array, tree)


def _summary(tr, traces, dispatches, final_params) -> dict:
    return {
        "losses": [m["loss"] for m in tr.metrics_log],
        "steps": [m["step"] for m in tr.metrics_log],
        "events": list(tr.events_log),
        "stats": {k: int(v) for k, v in tr.fault_stats.items()},
        "n_replicas": int(tr.n_replicas),
        "ft": bool(tr.ft_grad_allreduce),
        "traces": dict(traces),
        "dispatches": dict(dispatches),
        "final": final_params,
    }


def reference_run(case: Case, ckpt_dir: str) -> dict:
    """Run ``case`` through the reference; its summary and initial state."""
    cfg = jget(case.arch).smoke(n_layers=case.n_layers)
    mesh = make_mesh((case.data, 1), ("data", "model"))
    tr = jtrainer.Trainer(cfg, jtrainer.TrainerConfig(**case.trainer_kw(ckpt_dir)), mesh,
                          _data_cfg(JDataConfig, cfg, case))
    if case.no_buddies:
        tr.buddies = None
    p, o = tr.init_state()
    init = copy_tree((p, o))
    events = tuple(jtrainer.FaultEvent(*e) for e in case.events)
    with jdispatch.track_dispatch() as d:
        p, _ = tr.run(p, o, fault_schedule=events)
    out = _summary(tr, d.traces, d.dispatches, [np.array(x) for x in jax.tree.leaves(p)])
    out["init"] = init
    out["mesh_ids"] = [dev.id for dev in tr.mesh.devices.flat]
    out["template_ids"] = [dev.id for dev in tr._template_mesh.devices.flat]
    return out


def port_state(init):
    params, opt = init
    return params_from_reference(params, "cpu"), state_from_reference(opt, "cpu")


def port_trainer(case: Case, ckpt_dir: str):
    cfg = get_config(case.arch).smoke(n_layers=case.n_layers)
    tr = ttrainer.Trainer(cfg, ttrainer.TrainerConfig(**case.trainer_kw(ckpt_dir)),
                          ReplicaMesh.of((case.data, 1)), _data_cfg(DataConfig, cfg, case),
                          device="cpu")
    if case.no_buddies:
        tr.buddies = None
    return tr


def port_run(case: Case, ckpt_dir: str, init) -> dict:
    """Run ``case`` through the port on the CPU from the reference's
    initial state ``init``; its summary."""
    tr = port_trainer(case, ckpt_dir)
    p, o = port_state(init)
    events = tuple(ttrainer.FaultEvent(*e) for e in case.events)
    with tdispatch.track_dispatch() as d:
        p, _ = tr.run(p, o, fault_schedule=events)
    out = _summary(tr, d.traces, d.dispatches, [x.numpy() for x in leaves(p)])
    out["mesh_ids"] = [int(i) for i in tr.mesh.ids.flat]
    out["template_ids"] = [int(i) for i in tr._template_mesh.ids.flat]
    return out


def positions(ids: list[int], template: list[int]) -> list[int]:
    """Each id's place in the template's flat order (a device id of the
    reference, a replica-slot id of the port)."""
    return [template.index(i) for i in ids]


def assert_same_run(got: dict, want: dict, *, final: bool = True) -> None:
    assert without_stragglers(got["events"]) == without_stragglers(want["events"])
    assert got["stats"] == want["stats"]
    assert got["n_replicas"] == want["n_replicas"]
    assert got["ft"] == want["ft"]
    assert got["traces"] == want["traces"]
    assert got["dispatches"] == want["dispatches"]
    assert got["steps"] == want["steps"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert positions(got["mesh_ids"], got["template_ids"]) == \
        positions(want["mesh_ids"], want["template_ids"])
    if final:
        assert len(got["final"]) == len(want["final"])
        for g, w in zip(got["final"], want["final"]):
            np.testing.assert_allclose(g, w, rtol=PARAM_TOL, atol=PARAM_TOL)


@contextlib.contextmanager
def reference_sketch():
    """The port's low-rank basis refresh draws the reference's Ω."""
    def sketch(shape, device):
        omega = jax.random.normal(jax.random.key(0), shape, jnp.float32)
        return torch.from_numpy(np.array(omega)).to(device)

    saved = lowrank.sketch
    lowrank.sketch = sketch
    try:
        yield
    finally:
        lowrank.sketch = saved


# Multi-replica runs (tests/test_torch_elastic.py): the reference needs a
# JAX device per replica, so it computes them in a subprocess.
ELASTIC_CASES = {
    # BLANK over 4 replicas: the gradient combine on ft_allreduce, a
    # failure, a straggler masked for its step, a recovery
    "blank4": Case(data=4, tcfg=(("steps", 6), ("on_failure", "blank"), ("ckpt_every", 0)),
                   events=((1, "fail", 1, 1), (2, "straggle", 2, 1), (4, "recover", 1, 1))),
    # PowerSGD under BLANK on the MoE (the reference launcher's example):
    # the embedding compressed, every other leaf on one butterfly
    "powersgd_moe": Case(arch="qwen2-moe-a2.7b", data=4,
                         tcfg=(("steps", 4), ("on_failure", "blank"), ("ckpt_every", 0),
                               ("optimizer", "powersgd")),
                         events=((1, "fail", 3, 1), (3, "recover", 3, 1))),
    # SHRINK must drop the failed replica, not just halve the leading slice
    "shrink_dead": Case(n_layers=1, data=4,
                        tcfg=(("steps", 5), ("on_failure", "shrink"), ("ckpt_every", 0)),
                        events=((2, "fail", 1, 1),)),
    # a VLM batch keeps the fused gradient path (no replica axis)
    "vlm": Case(arch="qwen2-vl-72b", data=4,
                tcfg=(("steps", 2), ("on_failure", "blank"), ("ckpt_every", 0)),
                events=((1, "fail", 2, 1),)),
    # the SSM, hybrid and enc-dec families (tests/test_torch_train_families.py):
    # mamba2 under BLANK over 4 replicas with a failure and a recovery
    "mamba2_blank4": Case(arch="mamba2-2.7b", data=4,
                          tcfg=(("steps", 4), ("on_failure", "blank"), ("ckpt_every", 0)),
                          events=((1, "fail", 1, 1), (3, "recover", 1, 1))),
    # zamba2 at smoke() (one unit, no tail) over 2 replicas, a straggler
    "zamba2_blank2": Case(arch="zamba2-7b", data=2,
                          tcfg=(("steps", 3), ("on_failure", "blank"), ("ckpt_every", 0)),
                          events=((1, "straggle", 0, 1),)),
    # whisper fed SyntheticCorpus's frames over 2 replicas, a failure
    "whisper_blank2": Case(arch="whisper-medium", data=2,
                           tcfg=(("steps", 3), ("on_failure", "blank"), ("ckpt_every", 0)),
                           events=((2, "fail", 1, 1),)),
}


def reference_subprocess(tmp, parts: list[str]) -> dict:
    """The reference's outputs for ``parts`` (``"topology"``,
    ``"scenarios"`` or an :data:`ELASTIC_CASES` name), computed by this
    module run as a script in a subprocess with 8 forced host devices
    (``XLA_FLAGS`` set in its environment: ``jax_reference`` imports jax
    first, so the reference launcher's own setting would come too late)."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root / "src"), str(root / "tests")]),
               JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=8",
               TMPDIR=str(tmp))
    path = Path(tmp) / "reference.pkl"
    proc = subprocess.run([sys.executable, __file__, str(path), *parts], env=env, cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    with open(path, "rb") as f:
        out = pickle.load(f)
    assert out["devices"] == 8
    return out


def _where(m, template) -> list[int]:
    return positions([d.id for d in m.devices.flat], [d.id for d in template.devices.flat])


def _reference_topology() -> dict:
    """shrink_mesh / rebuild_mesh of the reference on 8 and 4 × 2 devices."""
    from repro.runtime import elastic as jelastic

    mesh = make_mesh((8, 1), ("data", "model"))
    ladder, m = [], mesh
    while m is not None:
        m = jelastic.shrink_mesh(m)
        ladder.append(None if m is None else (m.axis_names, m.devices.shape, _where(m, mesh)))
    drop = {}
    for k in range(1, 9):
        s = jelastic.shrink_mesh(mesh, drop_replicas=k)
        drop[k] = None if s is None else s.devices.shape
    m42 = make_mesh((4, 2), ("data", "model"))
    small, full = jelastic.shrink_mesh(m42), jelastic.rebuild_mesh(m42)
    return {"ladder": ladder, "drop": drop,
            "no_data_axis": jelastic.shrink_mesh(make_mesh((8,), ("model",))),
            "rebuild": (small.devices.shape, _where(small, m42), full.axis_names,
                        full.devices.shape, _where(full, m42))}


def _reference_scenarios() -> dict:
    """Each stock trainer scenario through the reference's
    ``run_trainer_scenario``, with the trainer's initial state and run
    captured around it."""
    from repro.bench import scenarios as jscen

    captured, out = {}, {}
    init_state, run = jtrainer.Trainer.init_state, jtrainer.Trainer.run

    def capture_init(self, key=None):
        p, o = init_state(self, key)
        captured["init"] = copy_tree((p, o))
        return p, o

    def capture_run(self, *args, **kw):
        with jdispatch.track_dispatch() as d:
            p, o = run(self, *args, **kw)
        captured["summary"] = dict(
            _summary(self, d.traces, d.dispatches, [np.array(x) for x in jax.tree.leaves(p)]),
            mesh_ids=[dev.id for dev in self.mesh.devices.flat],
            template_ids=[dev.id for dev in self._template_mesh.devices.flat])
        return p, o

    jtrainer.Trainer.init_state, jtrainer.Trainer.run = capture_init, capture_run
    try:
        for sc in jscen.get_scenarios():
            if sc.kind == "trainer":
                metrics = jscen.run_trainer_scenario(sc)
                out["scenario:" + sc.name] = dict(
                    captured["summary"], init=captured["init"],
                    metrics={k: (m.value, m.gate, m.direction, m.unit, m.tolerance)
                             for k, m in metrics.items()})
    finally:
        jtrainer.Trainer.init_state, jtrainer.Trainer.run = init_state, run
    return out


if __name__ == "__main__":
    import tempfile

    result = {"devices": jax.device_count()}
    for part in sys.argv[2:]:
        if part == "topology":
            result.update(_reference_topology())
        elif part == "scenarios":
            result.update(_reference_scenarios())
        else:
            result[part] = reference_run(ELASTIC_CASES[part], tempfile.mkdtemp())
    with open(sys.argv[1], "wb") as f:
        pickle.dump(result, f)
