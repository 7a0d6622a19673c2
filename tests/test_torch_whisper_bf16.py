"""Whisper in bf16 on f32 frames (``repro_torch.models.encdec``) against the
JAX package's on the CPU, at ``smoke()`` sizes with ``dtype="bfloat16"``.

``SyntheticCorpus`` builds Whisper's ``frames`` in f32 whatever the model's
dtype, as the reference's does.  ``jnp``'s ``@`` promotes f32 activations
against bf16 weights, so the encoder runs in f32 and the decoder's residual
turns f32 once the cross-attention output joins it; the port's products do
the same through ``layers.dot``.  The reference's decoder ``lax.scan``
refuses that carry (bf16 in, f32 out: a ``TypeError``), so the reference is
run with ``scan_layers=False``, its own Python unroll of the same layers;
the port always loops in Python.

Tolerances, measured on this comparison (the two libraries round their bf16
products of the decoder's first self-attention differently):

  * forward logits: 3.8e-3 of max|logit| read, held at ``FWD_TOL`` = 1e-2
    (one bf16 ulp is 2^-8 = 3.9e-3 relative);
  * the loss of ``loss_fn``: 3.1e-5 relative read, held at ``LOSS_RTOL``;
  * gradients: up to 1.04e-2 of a leaf's max read (a bf16 gradient of a bf16
    weight carries one rounding of 2^-8), held at ``GRAD_TOL`` = 2e-2; the key
    biases, whose exact gradient is 0, 4.6e-3 of the tree's max read, held
    absolutely at the same bound;
  * one AdamW step of the trainer: loss 1.0e-5 and gradient norm 1.4e-4
    relative read (held at 1e-4 and 1e-3); each parameter within 2·lr plus one
    bf16 ulp of the reference's (Adam's first step moves a parameter by about
    lr whatever the size of its gradient, so a gradient near 0 whose sign the
    two sides round apart moves it 2·lr apart; 880 of 157 952 elements differ,
    by at most 9.8e-4).
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax  # noqa: E402
from repro.compat import make_mesh  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticCorpus as JSyntheticCorpus  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402

import model_parity as mp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.models import api, params_from_reference  # noqa: E402
from repro_torch.optim import state_from_reference  # noqa: E402
from repro_torch.optim._tree import leaves  # noqa: E402
from repro_torch.runtime import trainer as ttrainer  # noqa: E402
from repro_torch.runtime.elastic import ReplicaMesh  # noqa: E402

ARCH = "whisper-medium"
B, S = 2, 24
FWD_TOL = 1e-2
LOSS_RTOL = 1e-4
GRAD_TOL = 2e-2
STEP_GNORM_RTOL = 1e-3
LR = 3e-4


def _data_cfg(make, cfg):
    return make(vocab=cfg.vocab, seq_len=S, global_batch=B, family=cfg.family,
                d_model=cfg.d_model, enc_frames=cfg.enc_frames)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jcfg = jget(ARCH).smoke(dtype="bfloat16", scan_layers=False)
    cfg = get_config(ARCH).smoke(dtype="bfloat16")
    jp = mp.ref_params(jcfg, 5)
    batch = mp.batch_np(jcfg, B, S, seed=6)
    weighted = dict(batch, loss_weight=np.array([1.0, 0.0], np.float32))
    logits = jax.jit(lambda p, b: japi.forward(p, b, jcfg))(jp, mp.to_jax(batch))
    loss, paths, grads = mp.reference_grads(jp, weighted, jcfg)

    # one trainer step (AdamW) on the corpus' first batch, f32 frames
    tr = jtrainer.Trainer(
        jcfg, jtrainer.TrainerConfig(steps=1, log_every=100, ckpt_every=0, lr=LR,
                                     ckpt_dir=str(tmp_path_factory.mktemp("ref_ckpt"))),
        make_mesh((1, 1), ("data", "model")), _data_cfg(JDataConfig, jcfg))
    p, o = tr.init_state()
    init = (mp.to_numpy(p), mp.to_numpy(o))
    host = JSyntheticCorpus(_data_cfg(JDataConfig, jcfg)).batch(0)
    p2, _, metrics = tr.step_fn(p, o, tr._device_batch(host))
    return {
        "cfg": cfg, "jp": jp, "batch": batch, "weighted": weighted,
        "logits": np.asarray(logits), "loss": loss, "paths": paths, "grads": grads,
        "init": init, "host": {k: np.asarray(v) for k, v in host.items()},
        "step_loss": float(metrics["loss"]), "step_gnorm": float(metrics["grad_norm"]),
        "step_params": [np.asarray(x, np.float32) for x in jax.tree.leaves(p2)],
    }


def test_config_is_bf16_and_the_frames_f32(ref):
    assert ref["cfg"].dtype == "bfloat16"
    assert ref["batch"]["frames"].dtype == np.float32
    assert ref["host"]["frames"].dtype == np.float32


def test_forward_on_f32_frames_matches_reference(ref):
    pp = mp.to_port(ref["jp"])
    assert pp["enc"]["attn"]["wq"].dtype == torch.bfloat16
    got = api.forward(pp, {k: torch.from_numpy(v) for k, v in ref["batch"].items()}, ref["cfg"])
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert mp.rel_err(got, ref["logits"]) <= FWD_TOL


def test_loss_and_grads_match_reference(ref):
    loss, grads = mp.loss_and_grads(
        mp.to_port(ref["jp"]), {k: torch.from_numpy(v) for k, v in ref["weighted"].items()},
        ref["cfg"])
    assert abs(float(loss) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    want = ref["grads"]
    assert [g.dtype for g in grads] == [getattr(torch, str(w.dtype)) for w in want]
    top = max(float(np.abs(w.astype(np.float32)).max()) for w in want)
    for g, w, path in zip(grads, want, ref["paths"]):
        w = w.astype(np.float32)
        if path.endswith(mp.ZERO_GRAD_LEAVES):
            assert float(np.abs(g.float().numpy() - w).max()) <= GRAD_TOL * top, path
        else:
            assert mp.rel_err(g.float(), w) <= GRAD_TOL, path


def test_one_trainer_step_matches_reference(ref):
    cfg = ref["cfg"]
    with tempfile.TemporaryDirectory() as d:
        tr = ttrainer.Trainer(
            cfg, ttrainer.TrainerConfig(steps=1, log_every=100, ckpt_every=0, lr=LR,
                                        ckpt_dir=d),
            ReplicaMesh.of((1, 1)), _data_cfg(DataConfig, cfg), device="cpu")
        params, opt = ref["init"]
        p, o = params_from_reference(params, "cpu"), state_from_reference(opt, "cpu")
        host = SyntheticCorpus(_data_cfg(DataConfig, cfg), "cpu").host_batch(0)
        for k, v in ref["host"].items():
            np.testing.assert_array_equal(host[k], v, err_msg=k)
        p2, _, metrics = tr.step_fn(p, o, tr._device_batch(host))
    assert float(metrics["loss"]) == pytest.approx(ref["step_loss"], rel=LOSS_RTOL)
    assert float(metrics["grad_norm"]) == pytest.approx(ref["step_gnorm"], rel=STEP_GNORM_RTOL)
    got = [x.float().numpy() for x in leaves(p2)]
    assert len(got) == len(ref["step_params"])
    for g, w in zip(got, ref["step_params"]):
        bound = 2 * LR + _bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
        assert (np.abs(g - w) <= bound).all()


def test_train_launcher_runs_whisper_in_bf16(monkeypatch, tmp_path, capsys):
    """``launch/train.py --arch whisper-medium`` at smoke widths in bf16 (the
    registry patched to hand the launcher that config as its published one)."""
    import repro_torch.configs as configs
    from repro_torch.launch import train

    real = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda arch: real(arch).smoke(dtype="bfloat16"))
    train.main(["--arch", ARCH, "--full", "--steps", "2", "--seq-len", "16",
                "--global-batch", "2", "--ckpt-every", "0", "--device", "cpu",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss:" in out
    loss = float(out.split("final loss:")[1].split()[0])
    assert np.isfinite(loss)
