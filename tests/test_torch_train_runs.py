"""Multi-replica training runs and the training launcher on the port
against the JAX package's on the CPU: a 4-replica BLANK run with a
failure, a straggler and a recovery (the gradient combine on
``ft_allreduce``), a 4-replica PowerSGD BLANK run on ``qwen2-moe-a2.7b``
(the reference launcher's example), a VLM run (the fused gradient path is
kept), and ``--faults shrink_then_rebuild`` through each package's
launcher in a fresh process.

The reference's runs need a JAX device per replica, so they go through a
subprocess with 8 forced host devices
(``trainer_parity.reference_subprocess``), once per module; the port runs
them in this process from the reference's initial states.  Tolerances:
``trainer_parity``'s.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)

import trainer_parity as tp  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime.trainer import FaultEvent  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.reference_subprocess(tmp_path_factory.mktemp("runs"),
                                   ["blank4", "powersgd_moe", "vlm"])


def _port_case(name, reference, tmp_path):
    return tp.port_run(tp.ELASTIC_CASES[name], str(tmp_path / "ck"), reference[name]["init"])


@pytest.mark.parametrize("name", ["blank4", "powersgd_moe", "vlm"])
def test_multi_replica_run_matches_reference(name, reference, tmp_path):
    got = _port_case(name, reference, tmp_path)
    tp.assert_same_run(got, reference[name])
    assert np.isfinite(got["losses"]).all()
    line = "gradient all-reduce: ft_allreduce over 4 replicas"
    # the VLM keeps the fused gradient path: no replica axis, no butterfly
    assert (line in got["events"]) == (name != "vlm") == got["ft"]


def test_blank_run_masks_failed_and_straggling_replicas(reference, tmp_path):
    got = _port_case("blank4", reference, tmp_path)
    assert got["stats"] == {"failures": 1, "recoveries": 1, "straggles": 1, "rollbacks": 0,
                            "buddy_restores": 0, "shrinks": 0, "rejoins": 0,
                            "masked_steps": 3}
    assert got["traces"] == {"train_step": 1} and got["dispatches"] == {"train_step": 6}


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

_REFERENCE_LAUNCHER = """
import sys
import jax_reference
from repro.launch.train import main
sys.argv = ["train"] + sys.argv[1:]
main()
"""


def _launch(cmd, **env_kw):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               JAX_PLATFORMS="cpu", **env_kw)
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600,
                         check=True)
    return out.stdout.strip().splitlines()


def _lines(lines):
    """The launcher's lines with the wall-clock straggler events taken out
    and the numbers that depend on the random initial weights (each side
    draws its own: ``jax.random`` against ``torch.Generator``) or on the
    clock replaced."""
    sub = re.compile(r"loss=[0-9.]+|gnorm=[0-9.]+|wall=[0-9.]+s|final loss: [0-9.]+")
    return [sub.sub("<x>", line) for line in tp.without_stragglers(lines)]


def test_faults_launcher_prints_the_reference_lines(tmp_path):
    """``python -m repro_torch.launch.train --faults shrink_then_rebuild``
    and the reference's launcher, each in a fresh process: the same events,
    fault stats and verdict lines, and the same ``[train]`` steps."""
    args = ["--arch", "olmo-1b", "--faults", "shrink_then_rebuild"]
    got = _launch([sys.executable, "-m", "repro_torch.launch.train", *args, "--device", "cpu",
                   "--ckpt-dir", str(tmp_path / "port")])
    want = _launch([sys.executable, "-c", _REFERENCE_LAUNCHER, *args,
                    "--ckpt-dir", str(tmp_path / "ref")],
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    assert _lines(got) == _lines(want)
    assert got[-2:] == ["fault stats: {'failures': 1, 'shrinks': 1, 'rejoins': 1}",
                        "scenario shrink_then_rebuild: fault stats match expectations"]
    assert "elastic shrink → mesh {'data': 2, 'model': 1}" in got
    losses = [float(m) for m in re.findall(r"loss=([0-9.]+)", "\n".join(got))]
    assert losses and np.isfinite(losses).all()


def test_launcher_blank_run_on_four_replicas(tmp_path, capsys):
    """``--mesh 4x1 --fail 2:1 --recover 4:1`` in process: BLANK with the
    gradient combine on the butterfly, the replica masked for two steps."""
    tr = train.run(train.parse_args([
        "--arch", "olmo-1b", "--mesh", "4x1", "--steps", "6", "--seq-len", "32",
        "--fail", "2:1", "--recover", "4:1", "--device", "cpu",
        "--ckpt-dir", str(tmp_path)]))
    out = capsys.readouterr().out.splitlines()
    assert "gradient all-reduce: ft_allreduce over 4 replicas" in out
    assert tr.fault_stats["masked_steps"] == 2 and tr.fault_stats["recoveries"] == 1
    assert out[-1].startswith("final loss: ")


def test_launcher_refuses_tensor_parallel_meshes_and_unknown_scenarios(tmp_path):
    for mesh in ("single", "multi"):
        with pytest.raises(NotImplementedError, match="A.3e"):
            train.make_mesh(mesh)
    with pytest.raises(NotImplementedError, match="A.3e"):
        train.build_trainer(train.parse_args(["--arch", "olmo-1b", "--mesh", "2x2",
                                              "--device", "cpu", "--ckpt-dir", str(tmp_path)]))
    with pytest.raises(SystemExit, match="trainer scenarios: buddy_pair_wipe, "
                                         "fail_during_rebuild, shrink_then_rebuild"):
        train.stock_scenario("nope")
    assert train.parse_events("3:1", "2:0:4", "5:1") == (
        FaultEvent(3, "fail", 1), FaultEvent(5, "recover", 1), FaultEvent(2, "straggle", 0, 4))
