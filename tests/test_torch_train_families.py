"""The port's trainer on the SSM, hybrid and enc-dec families against the
JAX package's on the CPU, at ``smoke()`` sizes: a 4-replica BLANK run of
mamba2 with a failure and a recovery, a 2-replica run of zamba2 (one unit,
no tail) with a masked straggler, and a 2-replica run of whisper whose
batches carry ``SyntheticCorpus``'s audio frames, with a failure.  Each
combines its gradients on ``ft_allreduce`` over the replicas.

The reference's runs need a JAX device per replica, so they go through a
subprocess with 8 forced host devices
(``trainer_parity.reference_subprocess``), once per module; the port runs
them in this process from the reference's initial states.  Events, fault
stats and ``train_step`` counts are equal exactly; losses and final
parameters within ``trainer_parity``'s tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)

import trainer_parity as tp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402

CASES = ["mamba2_blank4", "zamba2_blank2", "whisper_blank2"]
STATS = {
    "mamba2_blank4": {"failures": 1, "recoveries": 1, "masked_steps": 2},
    "zamba2_blank2": {"straggles": 1, "masked_steps": 1},
    "whisper_blank2": {"failures": 1, "masked_steps": 1},
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.reference_subprocess(tmp_path_factory.mktemp("families"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_family_run_matches_reference(name, reference, tmp_path):
    case = tp.ELASTIC_CASES[name]
    got = tp.port_run(case, str(tmp_path / "ck"), reference[name]["init"])
    tp.assert_same_run(got, reference[name])
    assert np.isfinite(got["losses"]).all() and len(got["losses"]) == dict(case.tcfg)["steps"]
    assert got["ft"] and (f"gradient all-reduce: ft_allreduce over {case.data} replicas"
                          in got["events"])
    assert {k: v for k, v in got["stats"].items() if v} == STATS[name]
    assert got["traces"] == {"train_step": 1}
    assert got["dispatches"] == {"train_step": dict(case.tcfg)["steps"]}


def test_whisper_batches_carry_the_frames():
    """The launcher's data config gives Whisper's batches ``enc_frames``
    frames of ``d_model`` (``launch/train.py``), split with the rows."""
    cfg = get_config("whisper-medium").smoke()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, family=cfg.family,
                      enc_frames=cfg.enc_frames, d_model=cfg.d_model)
    batch = SyntheticCorpus(dcfg, "cpu").batch(0)
    assert batch["frames"].shape == (4, cfg.enc_frames, cfg.d_model)
    assert batch["frames"].dtype == torch.float32
    half = SyntheticCorpus(dcfg, "cpu").batch(0, shard=1, n_shards=2)
    assert torch.equal(half["frames"], batch["frames"][2:])
