"""The port's checkpoint layer (``repro_torch.checkpoint``) against the JAX
package's on the CPU, and one run of the whole slice.

* Every case of the reference's ``tests/test_checkpoint.py`` on the port.
  The port raises ``ValueError`` on a shape mismatch where the reference
  asserts (an ``assert`` is gone under ``python -O``).
* A checkpoint written by either package restores in the other, bit for
  bit (the same ``step_XXXXXXXX/state.npz`` + ``MANIFEST.json`` layout).
* ``BuddyStore``'s placement, copies and recoveries equal the reference's
  for every power-of-two rank count up to 16 and every level, before and
  after failures and respawns.
* The slice end to end: AdamW, the low-rank optimizer and PowerSGD step a
  small parameter tree fed by ``SyntheticCorpus`` shards, with an async
  checkpoint saved and restored mid-run, on both sides; the parameters
  after the run agree within ``SLICE_TOL``.

Files go under ``tmp_path`` only, and every async save is waited on in
``finally``.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.checkpoint.replicated import BuddyStore as JBuddyStore  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import lowrank as jlowrank  # noqa: E402
from repro.optim import powersgd as jpsgd  # noqa: E402

from repro_torch.checkpoint import BuddyStore, CheckpointManager, flatten_tree, unflatten_like  # noqa: E402,E501
from repro_torch.data import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.optim import adamw, lowrank, powersgd, state_from_reference  # noqa: E402
from repro_torch.optim._tree import leaves  # noqa: E402


def _tree():
    return {
        "params": {"w": torch.arange(6.0).reshape(2, 3), "none": None},
        "opt": ({"m": torch.ones(4)}, {"v": torch.zeros(2)}),
        "step": torch.tensor(17),
    }


def _jtree():
    return {
        "params": {"w": jnp.arange(6.0).reshape(2, 3), "none": None},
        "opt": ({"m": jnp.ones((4,))}, {"v": jnp.zeros((2,))}),
        "step": jnp.asarray(17),
    }


def _wait_all(*mgrs):
    for m in mgrs:
        m.wait()


def test_flatten_roundtrip():
    t = _tree()
    flat = flatten_tree(t)
    back = unflatten_like(t, flat)
    assert back["params"]["none"] is None
    assert torch.equal(back["params"]["w"], t["params"]["w"])
    assert int(back["step"]) == 17
    assert set(flat) == set(jmanager.flatten_tree(_jtree()))


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(10, t)
    restored, meta = mgr.restore(t)
    assert meta["step"] == 10 and meta["n_arrays"] == len(flatten_tree(t))
    assert torch.equal(restored["opt"][0]["m"], torch.ones(4))


def test_keep_k_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree()
    try:
        th = mgr.save(5, t, block=False)
        assert isinstance(th, threading.Thread)
        t["params"]["w"].add_(100.0)          # the host copy was taken at save
    finally:
        mgr.wait()
    assert not th.is_alive()
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore(_tree())[0]["params"]["w"], _tree()["params"]["w"])


def test_incomplete_checkpoint_ignored(tmp_path):
    """A crash mid-write (tmp dir, no manifest) must not be restorable."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    (tmp_path / "step_00000009").mkdir()          # no MANIFEST.json
    (tmp_path / "step_00000008.tmp").mkdir()
    assert mgr.steps() == []
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree())
    mgr.save(3, _tree())
    assert mgr.latest_step() == 3


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, {"w": torch.ones(2, 2)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.ones(3, 3)})
    with pytest.raises(ValueError, match="not in the checkpoint"):
        mgr.restore({"u": torch.ones(2, 2)})


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_restores_in_the_other_package(tmp_path, writer):
    """The same layout: a port checkpoint restores in the reference (numpy
    leaves) and a reference checkpoint in the port (tensors), bit for bit."""
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "m": [rng.standard_normal(4).astype(np.float32), np.arange(3, dtype=np.int32)],
              "step": np.asarray(9, np.int32), "basis": None}
    port_tree = state_from_reference(arrays, "cpu")
    ref_tree = jax.tree.map(jnp.asarray, arrays)
    pm = CheckpointManager(str(tmp_path), keep=2)
    jm = jmanager.CheckpointManager(str(tmp_path), keep=2)
    try:
        if writer == "port":
            pm.save(4, port_tree, {"who": "port"}, block=False)
            pm.wait()
            got, meta = jm.restore(ref_tree)
            for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(arrays)):
                assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            jm.save(4, ref_tree, {"who": "reference"}, block=False)
            jm.wait()
            got, meta = pm.restore(port_tree)
            for g, w in zip(leaves(got), leaves(port_tree)):
                assert isinstance(g, torch.Tensor) and g.dtype == w.dtype
                assert torch.equal(g, w) and g.device == w.device
            assert got["basis"] is None and isinstance(got["m"], list)
        assert meta == {"who": writer, "step": 4, "n_arrays": 5}
        assert pm.steps() == jm.steps() == [4]
    finally:
        _wait_all(pm, jm)


# ---------------------------------------------------------------------------
# Diskless buddy store
# ---------------------------------------------------------------------------

def test_buddy_replication_counts():
    bs = BuddyStore(8)
    bs.checkpoint(1, {r: {"r": r} for r in range(8)}, levels=2)   # 2^2 = 4 copies
    for r in range(8):
        assert bs.copies(r) == 4


def test_buddy_recover_within_tolerance():
    bs = BuddyStore(8)
    bs.checkpoint(1, {r: {"val": torch.tensor(r * 10)} for r in range(8)}, levels=2)
    for dead in (0, 3, 5):                     # 3 = 2^2 - 1 deaths
        bs.fail(dead)
    for r in range(8):
        step, state = bs.recover(r)
        assert step == 1 and int(state["val"]) == r * 10


def test_buddy_tolerance_is_tight():
    bs = BuddyStore(4)
    bs.checkpoint(1, {r: {"v": r} for r in range(4)}, levels=1)  # 2 copies
    bs.fail(0)
    bs.fail(1)          # 2 failures > 2^1 - 1: shard 0 lived on {0,1} only
    with pytest.raises(KeyError):
        bs.recover(0)
    assert bs.recover(2)[1] == {"v": 2}


def test_buddy_respawn_rejoins():
    bs = BuddyStore(4)
    bs.checkpoint(1, {r: {"v": r} for r in range(4)}, levels=1)
    bs.fail(2)
    step, state = bs.recover(2)
    bs.respawn(2)
    bs.checkpoint(2, {2: state}, levels=1)
    assert bs.copies(2) >= 2


def test_buddy_rejects_a_rank_count_that_is_not_a_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        BuddyStore(6)


def _placement(store):
    return [sorted((owner, step) for owner, (step, _) in h.items()) for h in store.holdings]


@pytest.mark.parametrize("n_ranks", [1, 2, 4, 8, 16])
def test_buddy_placement_equals_the_reference(n_ranks):
    """For every level: the same holdings table, copies and recoveries as
    the reference's store, before and after failures and a respawn."""
    depth = n_ranks.bit_length() - 1
    for levels in range(depth + 2):
        port, ref = BuddyStore(n_ranks), JBuddyStore(n_ranks)
        shards = {r: {"v": r} for r in range(n_ranks)}

        def both(fn):
            fn(port), fn(ref)
            assert _placement(port) == _placement(ref)
            assert np.array_equal(port.alive, ref.alive)
            for r in range(n_ranks):
                assert port.replicas_of(r) == ref.replicas_of(r)
                assert port.copies(r) == ref.copies(r)
                try:
                    want = ref.recover(r)
                except KeyError:
                    with pytest.raises(KeyError):
                        port.recover(r)
                else:
                    assert port.recover(r) == want

        both(lambda s: s.checkpoint(1, shards, levels=levels))
        for dead in range(0, n_ranks, 3):
            both(lambda s, d=dead: s.fail(d))
        both(lambda s: s.respawn(0))
        both(lambda s: s.checkpoint(2, {r: {"v": -r} for r in range(0, n_ranks, 2)},
                                    levels=levels))


# ---------------------------------------------------------------------------
# The slice end to end
# ---------------------------------------------------------------------------

# Five steps of float32 arithmetic in another summation order, through
# Adam's normalization, a CholeskyQR2 basis refresh and PowerSGD's TSQR:
# relative to max(1, max|p|) the sides stay within ~1e-6; 2e-4 is the
# reference's own PowerSGD/CQR2 tolerance (tests/test_optim.py).
SLICE_TOL = 2e-4
V, D, R, SEQ, BATCH = 64, 16, 4, 8, 8


def _loss_np_params(rng):
    return {"emb": (rng.standard_normal((V, D)) * 0.5).astype(np.float32),
            "b": np.zeros(V, np.float32),
            "w": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32),
            "out": (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)}


def _jloss(p, tokens, labels):
    h = jnp.tanh(p["emb"][tokens] @ p["w"])
    logits = h @ p["out"] + p["b"]
    lse = jax.nn.logsumexp(logits, axis=-1)
    return jnp.mean(lse - jnp.take_along_axis(logits, labels[..., None], -1)[..., 0])


def _tloss(p, tokens, labels):
    h = torch.tanh(p["emb"][tokens.long()] @ p["w"])
    logits = h @ p["out"] + p["b"]
    return torch.nn.functional.cross_entropy(logits.reshape(-1, V), labels.long().reshape(-1))


def _tgrad(p, batch):
    leaf = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    gs = torch.autograd.grad(_tloss(leaf, batch["tokens"], batch["labels"]), list(leaf.values()))
    return dict(zip(leaf, gs))


def _run(side, steps, ckpt_dir, params, q0):
    """``steps`` training steps on one side.  Each step draws the global
    batch as R data shards, takes one gradient per shard, compresses the
    ``out`` gradients with PowerSGD over the R replicas (ft), averages the
    rest; AdamW steps ``emb`` and ``b``, the low-rank optimizer ``w`` and
    ``out``.  After step 2 the whole state is saved asynchronously,
    dropped and restored."""
    ref = side == "reference"
    cfg = dict(vocab=V, seq_len=SEQ, global_batch=BATCH, seed=5)
    a_kw = dict(lr=1e-2, warmup=1, total_steps=10, weight_decay=0.01)
    l_kw = dict(rank=4, refresh_every=2, min_dim=8, lr=1e-2)
    if ref:
        corpus = jpipe.SyntheticCorpus(jpipe.DataConfig(**cfg))
        opt_a, opt_l, psgd, mgr_cls = jadamw, jlowrank, jpsgd, jmanager.CheckpointManager
        p = jax.tree.map(jnp.asarray, params)
        q = jnp.asarray(q0)
    else:
        corpus = SyntheticCorpus(DataConfig(**cfg), device="cpu")
        opt_a, opt_l, psgd, mgr_cls = adamw, lowrank, powersgd, CheckpointManager
        p = state_from_reference(params, "cpu")
        q = torch.from_numpy(q0.copy())
    a_cfg, l_cfg = opt_a.AdamWConfig(**a_kw), opt_l.LowRankConfig(**l_kw)
    dense, proj = ("emb", "b"), ("w", "out")
    a_state = opt_a.init({k: p[k] for k in dense})
    l_state = opt_l.init({k: p[k] for k in proj}, l_cfg)
    mgr = mgr_cls(str(ckpt_dir), keep=2)
    try:
        for step in range(steps):
            shards = [corpus.batch(step, shard=s, n_shards=R) for s in range(R)]
            if ref:
                gs = [jax.grad(_jloss)(p, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
                      for b in shards]
                stack = lambda k: jnp.stack([g[k] for g in gs])  # noqa: E731
            else:
                gs = [_tgrad(p, b) for b in shards]
                stack = lambda k: torch.stack([g[k] for g in gs])  # noqa: E731
            g_out, q = psgd.compress_mean_grad(stack("out"), q,
                                               cfg=psgd.PowerSGDConfig(rank=4), ft=True)
            grads = {k: stack(k).mean(0) for k in ("emb", "b", "w")}
            grads["out"] = g_out
            new_a, a_state, _ = opt_a.update(a_cfg, {k: p[k] for k in dense},
                                             {k: grads[k] for k in dense}, a_state)
            new_l, l_state = opt_l.update(l_cfg, {k: p[k] for k in proj},
                                          {k: grads[k] for k in proj}, l_state)
            p = {**new_a, **new_l}
            if step == 2:
                state = {"params": p, "adamw": a_state, "lowrank": l_state, "q": q}
                mgr.save(step, state, block=False)
                mgr.wait()
                restored, meta = mgr.restore(state)
                assert meta["step"] == 2
                if ref:
                    restored = jax.tree.map(jnp.asarray, restored)
                p, a_state, l_state, q = (restored[k] for k in ("params", "adamw", "lowrank", "q"))
    finally:
        mgr.wait()
    return p, q


def test_slice_end_to_end_with_a_checkpoint_mid_run(tmp_path, monkeypatch):
    def sketch(shape, device):       # the reference's Ω (see test_torch_optim.py)
        return torch.from_numpy(np.array(jax.random.normal(jax.random.key(0), shape,
                                                           jnp.float32))).to(device)

    monkeypatch.setattr(lowrank, "sketch", sketch)
    rng = np.random.default_rng(21)
    params, q0 = _loss_np_params(rng), rng.standard_normal((V, 4)).astype(np.float32)
    got_p, got_q = _run("port", 5, tmp_path / "port", params, q0)
    want_p, want_q = _run("reference", 5, tmp_path / "reference", params, q0)
    assert sorted((tmp_path / "port").iterdir()) != []
    for k in params:
        g, w = got_p[k].detach().numpy(), np.asarray(want_p[k])
        assert g.dtype == w.dtype == np.float32 and np.isfinite(g).all()
        assert not np.array_equal(g, params[k])                    # every leaf moved
        assert np.abs(g - w).max() <= SLICE_TOL * max(1.0, np.abs(w).max()), k
    assert np.abs(got_q.numpy() - np.asarray(want_q)).max() <= SLICE_TOL * max(
        1.0, np.abs(np.asarray(want_q)).max())


def test_bf16_leaves_round_trip_in_the_reference_layout(tmp_path):
    """A bf16 leaf (the trainer's bf16 parameters) is written as its 2-byte
    patterns, ``|V2``, which is what the reference's ``np.savez`` writes
    for a bf16 array, and comes back as bf16 with the same bits; either
    package's bf16 checkpoint restores into the port's bf16 template."""
    w = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    CheckpointManager(str(tmp_path / "port")).save(1, {"w": w})
    with np.load(tmp_path / "port" / "step_00000001" / "state.npz") as z:
        assert z["w"].dtype == np.dtype("V2")
    jmanager.CheckpointManager(str(tmp_path / "ref")).save(
        1, {"w": jnp.asarray(w.float().numpy(), jnp.bfloat16)})
    for side in ("port", "ref"):
        state, _ = CheckpointManager(str(tmp_path / side)).restore({"w": torch.zeros_like(w)})
        assert state["w"].dtype == torch.bfloat16
        assert torch.equal(state["w"].view(torch.int16), w.view(torch.int16))
