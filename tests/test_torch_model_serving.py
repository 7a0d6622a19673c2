"""The port's model serving path (``prefill``, ``decode_step``, the
``--mode model`` launcher) against the JAX package's on the CPU, for all ten
architectures at ``smoke()`` sizes: the seven of the transformer families,
Mamba2, Zamba2 and Whisper.

* With the reference's parameters carried across: ``prefill`` logits and
  every cache tensor, then ``decode_step`` logits and caches, within
  ``model_parity.TOL``; greedy ids equal to the reference's greedy loop
  (each step's top two logits at least ``GREEDY_MARGIN`` apart, so no id
  hangs on rounding).
* Every case of the reference's ``tests/test_serving.py`` and
  ``tests/test_models_smoke.py`` for these architectures, on the port's own
  parameters, with the reference's tolerances: prefill-then-decode ≡
  forward, multi-step decode (qwen3, mamba2, zamba2), the ring buffer past
  its window, shapes and
  finiteness, finite gradients, the loss falling under SGD, the softcap
  bound, M-RoPE shifts, the sliding-window mask.
* The launcher of each side in a fresh process prints the same lines.

The reference's outputs are computed once per architecture (jitted).
"""
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import api as japi  # noqa: E402

import model_parity as mp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim._tree import leaves, map_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x22b", "gemma2-9b", "olmo-1b", "qwen3-0.6b",
         "minitron-4b", "qwen2-vl-72b", "mamba2-2.7b", "zamba2-7b", "whisper-medium"]
B, S, GEN = 2, 24, 5
S_MAX = S + 4
# the reference tests' own tolerances (rtol = atol)
SERVE_TOL = 3e-3
MULTI_TOL = 5e-3
GREEDY_MARGIN = 1e-4


def _prefix(batch, n):
    return {k: (v[..., :n] if k in ("tokens", "positions") else v)
            for k, v in batch.items() if k != "labels"}


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    jcfg = jget(arch).smoke()
    jp = mp.ref_params(jcfg, 7)
    batch = mp.batch_np(jcfg, B, S, seed=7)
    prefill = jax.jit(lambda p, b: japi.prefill(p, b, jcfg, s_max=S_MAX))
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jcfg))
    lp, cache = prefill(jp, mp.to_jax(_prefix(batch, S - 1)))
    ld, cache2 = decode(jp, cache, jnp.asarray(batch["tokens"][:, S - 1:]))
    # the reference launcher's greedy loop from the prefill of the whole prompt
    logits, c = prefill(jp, mp.to_jax(_prefix(batch, S - GEN)))
    steps, ids = [np.asarray(logits)], []
    for _ in range(GEN):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        ids.append(np.asarray(tok))
        logits, c = decode(jp, c, tok)
        steps.append(np.asarray(logits))
    return types.SimpleNamespace(
        arch=arch, cfg=get_config(arch).smoke(), jp=jp, batch=batch, lp=np.asarray(lp),
        cache=mp.to_numpy(cache), ld=np.asarray(ld), cache2=mp.to_numpy(cache2),
        ids=np.concatenate(ids, axis=1), steps=steps[:-1])


def _assert_cache_close(got, want):
    """Every family's cache: the same tree, ``len`` equal, each tensor
    (KV caches, recurrent states, cross K/V) f32 within ``TOL``."""
    assert int(got["len"]) == int(want["len"])
    assert all(t.dtype == torch.float32 for t in leaves(got) if t.dim())
    mp.assert_tree_close(got, want)


def test_prefill_and_cache_match_reference(case):
    params = mp.to_port(case.jp)
    with torch.no_grad():
        lp, cache = api.prefill(params, mp.to_port(_prefix(case.batch, S - 1)), case.cfg,
                                s_max=S_MAX)
    assert mp.rel_err(lp, case.lp) <= mp.TOL
    _assert_cache_close(cache, case.cache)


def test_decode_step_matches_reference(case):
    params = mp.to_port(case.jp)
    with torch.no_grad():
        _, cache = api.prefill(params, mp.to_port(_prefix(case.batch, S - 1)), case.cfg,
                               s_max=S_MAX)
        before = map_params(torch.clone, cache)
        token = torch.from_numpy(case.batch["tokens"][:, S - 1:])
        ld, cache2 = api.decode_step(params, cache, token, case.cfg)
    assert mp.rel_err(ld, case.ld) <= mp.TOL
    _assert_cache_close(cache2, case.cache2)
    assert all(torch.equal(a, b) for a, b in zip(leaves(before), leaves(cache)))


def test_greedy_ids_match_reference(case):
    for logits in case.steps:
        top = np.sort(logits, axis=-1)
        assert (top[:, -1] - top[:, -2]).min() >= GREEDY_MARGIN * np.abs(logits).max()
    prompt = mp.to_port(_prefix(case.batch, S - GEN))
    run = generate(mp.to_port(case.jp), prompt, case.cfg, GEN, s_max=S_MAX)
    np.testing.assert_array_equal(run.ids.numpy(), case.ids)


# -- the reference's tests/test_serving.py on the port -----------------------

@pytest.fixture(scope="module")
def gen():
    return lambda: torch.Generator().manual_seed(7)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(gen, arch):
    cfg = get_config(arch).smoke()
    params = api.init(gen(), cfg, device="cpu")
    batch = api.synth_batch(gen(), cfg, "train", 2, S, device="cpu")
    with torch.no_grad():
        full = api.forward(params, batch, cfg)
        lp, cache = api.prefill(params, _prefix(batch, S - 1), cfg, s_max=S + 4)
        ld, _ = api.decode_step(params, cache, batch["tokens"][:, S - 1:S], cfg)
    np.testing.assert_allclose(lp.numpy(), full[:, S - 2].numpy(), rtol=SERVE_TOL, atol=SERVE_TOL)
    np.testing.assert_allclose(ld.numpy(), full[:, S - 1].numpy(), rtol=SERVE_TOL, atol=SERVE_TOL)


def _decode_along(cfg, params, toks, start, s_max):
    """Prefill ``toks[:, :start]``, then decode each later token; the logits
    of every step but the last against the teacher-forced forward."""
    with torch.no_grad():
        full = api.forward(params, {"tokens": toks}, cfg)
        _, cache = api.prefill(params, {"tokens": toks[:, :start]}, cfg, s_max=s_max)
        n = toks.shape[1]
        for t in range(start, n):
            ld, cache = api.decode_step(params, cache, toks[:, t:t + 1], cfg)
            if t < n - 1:
                np.testing.assert_allclose(ld.numpy(), full[:, t].numpy(),
                                           rtol=MULTI_TOL, atol=MULTI_TOL)


def test_multi_step_decode_consistency(gen):
    """Greedy decode via repeated decode_step == teacher-forced forward."""
    cfg = get_config("qwen3-0.6b").smoke()
    params = api.init(gen(), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 20), generator=gen(), dtype=torch.int32)
    _decode_along(cfg, params, toks, 12, 24)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_multi_step_decode_consistency_of_the_recurrent_families(gen, arch):
    """The reference's case for mamba2 and zamba2: greedy decode via repeated
    decode_step == teacher-forced forward (the recurrent states and the
    shared block's KV caches carried over 8 steps)."""
    cfg = get_config(arch).smoke()
    params = api.init(gen(), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 20), generator=gen(), dtype=torch.int32)
    _decode_along(cfg, params, toks, 12, 24)


def test_ring_buffer_window_decode(gen):
    """Decode past the window with a ring cache must equal the full forward
    (sliding-window exactness)."""
    cfg = get_config("mixtral-8x22b").smoke(n_layers=1, n_experts=2, top_k=1, sliding_window=8)
    params = api.init(gen(), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 24), generator=gen(), dtype=torch.int32)
    _decode_along(cfg, params, toks, 8, 24)


# -- the reference's tests/test_models_smoke.py on the port ------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finite(gen, arch):
    cfg = get_config(arch).smoke()
    params = api.init(gen(), cfg, device="cpu")
    batch = api.synth_batch(gen(), cfg, "train", 2, 32, device="cpu")
    with torch.no_grad():
        logits = api.forward(params, batch, cfg)
    assert logits.shape == (2, 32, cfg.vocab) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_grads_finite(gen, arch):
    cfg = get_config(arch).smoke()
    params = api.init(gen(), cfg, device="cpu")
    batch = api.synth_batch(gen(), cfg, "train", 2, 32, device="cpu")
    flat = [t.requires_grad_(True) for t in leaves(params)]
    loss = api.loss_fn(params, batch, cfg)
    assert torch.isfinite(loss)
    for g in torch.autograd.grad(loss, flat):
        assert torch.isfinite(g.float()).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_improves_under_sgd(gen, arch):
    """Five tiny steps on a fixed batch must reduce the loss — catches dead
    gradients (e.g. a detached router or frozen norm)."""
    cfg = get_config(arch).smoke(n_layers=2)
    params = api.init(gen(), cfg, device="cpu")
    batch = api.synth_batch(gen(), cfg, "train", 2, 16, device="cpu")

    def step(p):
        p = map_params(lambda x: x.detach().requires_grad_(True), p)
        loss = api.loss_fn(p, batch, cfg)
        grads = dict(zip(map(id, leaves(p)), torch.autograd.grad(loss, leaves(p))))
        return float(loss.detach()), map_params(
            lambda x: (x.float() - 0.05 * grads[id(x)].float()).to(x.dtype), p)

    l0, params = step(params)
    for _ in range(5):
        l1, params = step(params)
    assert l1 < l0, (arch, l0, l1)


def test_gemma2_softcap_applied(gen):
    cfg = get_config("gemma2-9b").smoke()
    assert cfg.final_logit_softcap == 30.0
    params = api.init(gen(), cfg, device="cpu")
    batch = api.synth_batch(gen(), cfg, "train", 1, 16, device="cpu")
    with torch.no_grad():
        logits = api.forward(params, batch, cfg)
    assert float(logits.abs().max()) <= 30.0 + 1e-3


def test_mrope_positions_change_output(gen):
    cfg = get_config("qwen2-vl-72b").smoke()
    params = api.init(gen(), cfg, device="cpu")
    batch = api.synth_batch(gen(), cfg, "train", 1, 32, device="cpu")
    with torch.no_grad():
        l1 = api.forward(params, batch, cfg)
        shifted = batch["positions"].clone()
        shifted[1] += 5                                   # shift the h-stream
        l2 = api.forward(params, dict(batch, positions=shifted), cfg)
    assert not np.allclose(l1.numpy(), l2.numpy())


def test_sliding_window_masks_long_range(gen):
    """With a tiny window, distant tokens must not influence logits."""
    cfg = get_config("mixtral-8x22b").smoke(n_layers=1, n_experts=2, top_k=1, sliding_window=4)
    params = api.init(gen(), cfg, device="cpu")
    toks = torch.zeros((1, 16), dtype=torch.int32)
    toks2 = toks.clone()
    toks2[0, 0] = 5                                       # beyond window of position 15
    with torch.no_grad():
        base = api.forward(params, {"tokens": toks}, cfg)
        pert = api.forward(params, {"tokens": toks2}, cfg)
    np.testing.assert_allclose(base[0, -1].numpy(), pert[0, -1].numpy(), rtol=1e-4, atol=1e-4)
    # ...but a causal model without the window would see it at position 3
    assert not np.allclose(base[0, 3].numpy(), pert[0, 3].numpy())


# -- the launcher -------------------------------------------------------------

_REFERENCE_LAUNCHER = """
import sys
import jax_reference
from repro.launch.serve import main
sys.argv = ["serve"] + sys.argv[1:]
main()
"""


def _launch(cmd):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600,
                         check=True)
    return out.stdout.strip().splitlines()


def _shape(lines):
    """The launcher's lines with clock readings and ids taken out."""
    clock = re.compile(r"[0-9.]+ ?ms|(?<=: )\[[0-9, ]*\]")
    return [clock.sub("<n>", line) for line in lines]


def test_model_launcher_prints_the_reference_lines():
    """``python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --device
    cpu`` and the reference's launcher, each in a fresh process, print the
    same two lines, with as many generated ids (the parameters differ: each
    side draws its own from seed 0)."""
    args = ["--arch", "qwen2-moe-a2.7b", "--batch", "2", "--prompt-len", "16", "--gen", "6"]
    got = _launch([sys.executable, "-m", "repro_torch.launch.serve", *args, "--device", "cpu"])
    want = _launch([sys.executable, "-c", _REFERENCE_LAUNCHER, *args])
    assert _shape(got) == _shape(want) == [
        "arch=qwen2-moe-a2.7b-smoke prefill(2x16)=<n> decode 6 steps=<n> (<n>/tok)",
        "generated ids[0]: <n>"]
    ids = [re.search(r"\[(.*)\]", lines[-1]).group(1).split(", ") for lines in (got, want)]
    assert len(ids[0]) == len(ids[1]) == 6
