"""The port's data pipeline (``repro_torch.data``) against the JAX package's
``repro.data.pipeline`` on the CPU: every case of the reference's
``tests/test_data.py`` on the port, and each batch equal to the reference's
bit for bit, for every shard split, handed over as tensors on the device the
caller names.  Every Prefetcher is closed in ``finally`` and its thread
checked gone."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
from repro.data import pipeline as jpipe  # noqa: E402

from repro_torch.data import DataConfig, Prefetcher, SyntheticCorpus, make_batches  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402


def _kw(**kw):
    base = dict(vocab=1000, seq_len=32, global_batch=16, seed=3)
    base.update(kw)
    return base


def _corpus(**kw):
    return SyntheticCorpus(DataConfig(**_kw(**kw)), device="cpu")


def _ref(**kw):
    return jpipe.SyntheticCorpus(jpipe.DataConfig(**_kw(**kw)))


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert np.array_equal(g, v), k


def test_deterministic():
    c1, c2 = _corpus(), _corpus()
    b1, b2 = c1.batch(7), c2.batch(7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], c1.batch(8)["tokens"])


def test_labels_are_shifted_tokens():
    b = _corpus().batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_shard_composability():
    """concat(shards at width k) == the full batch, for every k."""
    corpus = _corpus()
    full = corpus.batch(5)["tokens"]
    for n_shards in (2, 4, 8):
        parts = [corpus.batch(5, shard=s, n_shards=n_shards)["tokens"] for s in range(n_shards)]
        assert torch.equal(torch.cat(parts, 0), full)


def test_token_range_and_structure():
    b = _corpus(vocab=128).batch(2)
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 128
    assert b["tokens"].dtype == torch.int32 and b["tokens"].device.type == "cpu"


def test_encdec_and_vlm_extras():
    b = _corpus(family="encdec", enc_frames=8, d_model=16).batch(0)
    assert b["frames"].shape == (16, 8, 16) and b["frames"].dtype == torch.float32
    b = _corpus(family="vlm").batch(0)
    assert b["positions"].shape == (3, 16, 32) and b["positions"].dtype == torch.int32


def test_prefetcher():
    corpus = _corpus()
    pf = Prefetcher(corpus, start_step=3, depth=2)
    try:
        s1, b1 = pf.next()
        s2, _ = pf.next()
        assert (s1, s2) == (3, 4)
        assert torch.equal(b1["tokens"], corpus.batch(3)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("family,extra", [("dense", {}), ("encdec", dict(enc_frames=5, d_model=3)),
                                          ("vlm", {})])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8, 16])
def test_batches_equal_the_reference_bit_for_bit(family, extra, n_shards):
    """Every shard of every step equals the reference's batch, for every
    data-parallel width, on both the host and the handed-over tensors."""
    kw = dict(family=family, **extra)
    port, ref = _corpus(**kw), _ref(**kw)
    for step in (0, 1, 9, 1 << 20):
        for shard in range(n_shards):
            want = ref.batch(step, shard=shard, n_shards=n_shards)
            _equal(port.host_batch(step, shard=shard, n_shards=n_shards), want)
            _equal(port.batch(step, shard=shard, n_shards=n_shards), want)


@pytest.mark.parametrize("seed,vocab,seq_len", [(0, 50304, 64), (7, 2, 9), (123, 32000, 1)])
def test_counter_hash_and_vocab_edges_equal_the_reference(seed, vocab, seq_len):
    x = np.arange(1 << 12, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    assert np.array_equal(tpipe._counter_hash(x), jpipe._counter_hash(x))
    kw = dict(seed=seed, vocab=vocab, seq_len=seq_len, global_batch=4)
    _equal(_corpus(**kw).batch(3), _ref(**kw).batch(3))


def test_make_batches_and_prefetcher_follow_the_reference():
    kw = _kw(global_batch=8)
    want = list(jpipe.make_batches(jpipe.DataConfig(**kw), 3, start=2))
    got = list(make_batches(DataConfig(**kw), 3, start=2, device="cpu"))
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 3, 4]
    for (_, g), (_, w) in zip(got, want):
        _equal(g, w)
    pf = Prefetcher(_corpus(global_batch=8), start_step=2, depth=1, shard=1, n_shards=2)
    try:
        for step in (2, 3, 4):
            s, b = pf.next()
            assert s == step
            _equal(b, _ref(global_batch=8).batch(step, shard=1, n_shards=2))
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_default_device_is_the_card(monkeypatch):
    """With no device named the corpus hands batches to the card, and
    without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticCorpus(DataConfig(**_kw()))
