"""The port's fault-tolerant trainer (``repro_torch.runtime.trainer``)
against the JAX package's on the CPU, one replica: every case of
``tests/test_trainer.py`` (the multi-replica cases are in
``test_torch_elastic.py`` and ``test_torch_train_runs.py``).

Each case runs once through the reference (in this process, on its one CPU
device) and once through the port from the reference's initial state
(``trainer_parity``): events logs (straggler lines out), fault stats,
replica counts, ``train_step`` trace and dispatch dicts equal; losses
within ``LOSS_RTOL``; final parameters within ``PARAM_TOL`` of
max|param|.  The reference outputs are computed once per module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
from repro.compat import make_mesh  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.data.pipeline import SyntheticCorpus as JCorpus  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402

import trainer_parity as tp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.kernels import dispatch as tdispatch  # noqa: E402
from repro_torch.runtime import elastic, trainer  # noqa: E402

CASES = {
    "loss_decreases": tp.Case(tcfg=(("steps", 10), ("ckpt_every", 0))),
    "microbatched": tp.Case(tcfg=(("steps", 3), ("microbatches", 2), ("ckpt_every", 0))),
    "rebuild_rollback": tp.Case(
        tcfg=(("steps", 8), ("ckpt_every", 3), ("on_failure", "rebuild"), ("buddy_levels", 0)),
        events=((5, "fail", 0, 1),), no_buddies=True),
    "blank": tp.Case(tcfg=(("steps", 6), ("on_failure", "blank"), ("ckpt_every", 0)),
                     events=((3, "fail", 0, 1), (5, "recover", 0, 1))),
    "straggler": tp.Case(tcfg=(("steps", 5), ("ckpt_every", 0), ("drop_stragglers", True)),
                         events=((2, "straggle", 0, 1),)),
    "powersgd": tp.Case(tcfg=(("steps", 3), ("ckpt_every", 0), ("optimizer", "powersgd"))),
    "orthosgd": tp.Case(tcfg=(("steps", 3), ("ckpt_every", 0), ("optimizer", "orthosgd"))),
    "lowrank": tp.Case(tcfg=(("steps", 3), ("ckpt_every", 0), ("optimizer", "lowrank"))),
    "restart": tp.Case(tcfg=(("steps", 6), ("ckpt_every", 2))),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case through the reference, once."""
    return {name: tp.reference_run(case, str(tmp_path_factory.mktemp(f"ref_{name}")))
            for name, case in CASES.items()}


def _port(name, reference, tmp_path):
    with tp.reference_sketch():
        return tp.port_run(CASES[name], str(tmp_path / "ck"), reference[name]["init"])


@pytest.mark.parametrize("name", list(CASES))
def test_run_matches_reference(name, reference, tmp_path):
    got = _port(name, reference, tmp_path)
    tp.assert_same_run(got, reference[name])
    assert np.isfinite(got["losses"]).all()


def test_loss_decreases(reference, tmp_path):
    losses = _port("loss_decreases", reference, tmp_path)["losses"]
    assert len(losses) == 10 and losses[-1] < losses[0]


def test_microbatched_step_matches_tokens(reference, tmp_path):
    got = _port("microbatched", reference, tmp_path)
    assert len(got["losses"]) == 3 and np.isfinite(got["losses"]).all()


def test_checkpoint_and_rebuild_rollback(reference, tmp_path):
    got = _port("rebuild_rollback", reference, tmp_path)
    log = " ".join(got["events"])
    assert "FAILED → rebuild" in log
    assert "rollback to checkpoint step 3" in log
    # the run re-executed steps 4.. after the rollback and finished
    assert got["steps"] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert got["stats"]["rollbacks"] == 1 and got["dispatches"] == {"train_step": 9}


def test_blank_semantics_masks_replica(reference, tmp_path):
    got = _port("blank", reference, tmp_path)
    log = " ".join(got["events"])
    assert "FAILED → blank" in log and "recovered" in log
    assert len(got["losses"]) == 6 and got["stats"]["masked_steps"] == 2


def test_straggler_detection_and_masking(reference, tmp_path):
    got = _port("straggler", reference, tmp_path)
    assert any("straggling" in e for e in got["events"])
    assert got["stats"]["straggles"] == 1 and got["stats"]["masked_steps"] == 1


def test_shrink_mesh_topology():
    mesh = elastic.ReplicaMesh.of((1, 1))
    assert elastic.shrink_mesh(mesh) is None          # cannot shrink below 1
    assert jelastic.shrink_mesh(make_mesh((1, 1), ("data", "model"))) is None


@pytest.mark.parametrize("optimizer", ["powersgd", "orthosgd", "lowrank"])
def test_optimizer_wiring_finite(optimizer, reference, tmp_path):
    losses = _port(optimizer, reference, tmp_path)["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all(), losses


def _cache_hit(tr, corpus, batch0, batch1, track, trace_count, rebuild):
    """The reference test's steps: a warm step, a remesh onto the rebuilt
    template, one more step; the counts it asserts."""
    p, o = tr._init
    p, o, _ = tr.step_fn(p, o, tr._device_batch(batch0))
    entries = len(tr._step_cache)
    before = trace_count("train_step")
    p, o = tr._remesh(p, o, rebuild(tr._template_mesh))
    with track() as stats:
        p, o, _ = tr.step_fn(p, o, tr._device_batch(batch1))
    return {"entries": entries, "entries_after": len(tr._step_cache),
            "new_traces": trace_count("train_step") - before,
            "traces": dict(stats.traces), "dispatches": dict(stats.dispatches)}


def test_rebuild_mesh_hits_step_cache(tmp_path):
    """Elastic zero-retrace contract: a mesh rebuilt from the template is a
    new object but the same equivalence class, so ``_remesh`` reuses the
    cached step — zero new traces, one dispatch per step — on both sides,
    the counts compared as whole dicts."""
    case = tp.Case(tcfg=(("steps", 2), ("ckpt_every", 0)))
    jcfg = jget("olmo-1b").smoke(n_layers=2)
    jtr = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(**case.trainer_kw(str(tmp_path / "ref"))),
                           make_mesh((1, 1), ("data", "model")),
                           tp._data_cfg(tp.JDataConfig, jcfg, case))
    jtr._init = jtr.init_state()
    init = tp.copy_tree(jtr._init)
    jc = JCorpus(jtr.data_cfg)
    want = _cache_hit(jtr, jc, jc.batch(0), jc.batch(1), jdispatch.track_dispatch,
                      jdispatch.trace_count, jelastic.rebuild_mesh)

    ttr = tp.port_trainer(case, str(tmp_path / "port"))
    ttr._init = tp.port_state(init)
    tc = SyntheticCorpus(ttr.data_cfg, "cpu")
    got = _cache_hit(ttr, tc, tc.host_batch(0), tc.host_batch(1), tdispatch.track_dispatch,
                     tdispatch.trace_count, elastic.rebuild_mesh)
    assert got == want
    assert got == {"entries": 1, "entries_after": 1, "new_traces": 0, "traces": {},
                   "dispatches": {"train_step": 1}}


def test_checkpoint_restart_reproduces_data(reference, tmp_path):
    """Restore + rerun sees exactly the batches a never-failed run sees
    (counter-mode corpus): the loss curve after the restore point matches
    the uninterrupted run's, the port's and the reference's."""
    case, want = CASES["restart"], reference["restart"]
    tr1 = tp.port_trainer(case, str(tmp_path / "a"))
    p, o = tp.port_state(want["init"])
    tr1.run(p, o)
    base = {m["step"]: m["loss"] for m in tr1.metrics_log}

    tr2 = tp.port_trainer(case, str(tmp_path / "a"))
    p2, o2 = tr2.init_state()
    state, meta = tr2.ckpt.restore({"params": p2, "opt": o2})
    assert meta["step"] == 4 and state["opt"]["step"].device.type == "cpu"
    tr2.run(state["params"], state["opt"], start_step=int(meta["step"]) + 1)
    assert [m["step"] for m in tr2.metrics_log] == [5]
    for m in tr2.metrics_log:
        np.testing.assert_allclose(m["loss"], base[m["step"]], rtol=tp.LOSS_RTOL)
        np.testing.assert_allclose(m["loss"], want["losses"][m["step"]], rtol=tp.LOSS_RTOL)


def test_trainer_device_defaults_to_the_card(tmp_path):
    case = tp.Case()
    cfg = get_config("olmo-1b").smoke(n_layers=2)
    args = (cfg, trainer.TrainerConfig(**case.trainer_kw(str(tmp_path))),
            elastic.ReplicaMesh.of((1, 1)), DataConfig(vocab=cfg.vocab, seq_len=32,
                                                       global_batch=8))
    if torch.cuda.is_available():
        assert trainer.Trainer(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            trainer.Trainer(*args)


def test_model_axis_waits_for_distcomm(tmp_path):
    cfg = get_config("olmo-1b").smoke(n_layers=1)
    with pytest.raises(NotImplementedError, match="A.3e"):
        trainer.Trainer(cfg, trainer.TrainerConfig(ckpt_dir=str(tmp_path)),
                        elastic.ReplicaMesh.of((2, 2)),
                        DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8), device="cpu")
