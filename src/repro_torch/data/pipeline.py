"""Deterministic, shardable synthetic data pipeline.

The port of :mod:`repro.data.pipeline`: an index-based corpus whose
``(step, row)`` → tokens mapping is a counter-mode hash, so any worker can
materialize any shard of any step independently — a restored run at step
k regenerates exactly the batches a never-failed run would have seen, for
any data-parallel width.  The batch is built on the host with the
reference's arithmetic (:meth:`SyntheticCorpus.host_batch`, equal to the
reference's bit for bit) and handed over as tensors on the corpus's device.

A small background prefetcher overlaps host batch synthesis with device
compute.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from repro_torch.collective.comm import resolve_device

__all__ = ["DataConfig", "SyntheticCorpus", "Prefetcher", "make_batches"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    family: str = "dense"
    enc_frames: int = 0
    d_model: int = 0


_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _counter_hash(x: np.ndarray) -> np.ndarray:
    """splitmix64 — a counter-mode PRF, vectorized."""
    x = x.astype(np.uint64)
    z = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK
    return z ^ (z >> np.uint64(31))


def _to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


class SyntheticCorpus:
    """Zipf-ish token streams with enough structure for loss to decrease
    (each token repeats its predecessor with probability 1/2).
    ``device=None`` hands batches over on the card."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def host_batch(self, step: int, *, shard: int = 0, n_shards: int = 1) -> dict:
        """Rows ``[shard·B/n, (shard+1)·B/n)`` of global batch ``step`` as
        numpy arrays: ``tokens``/``labels`` (rows, seq_len) int32, plus
        ``frames`` (encdec) or ``positions`` (vlm)."""
        cfg = self.cfg
        rows = cfg.global_batch // n_shards
        row0 = shard * rows
        idx = (
            np.uint64(step) * np.uint64(cfg.global_batch * (cfg.seq_len + 1))
            + (np.arange(rows, dtype=np.uint64)[:, None] + np.uint64(row0))
            * np.uint64(cfg.seq_len + 1)
            + np.arange(cfg.seq_len + 1, dtype=np.uint64)[None, :]
            + np.uint64(cfg.seed) * np.uint64(0x1000003)
        )
        h = _counter_hash(idx)
        # Fresh tokens keep a heavy-tailed Zipf marginal; each position
        # repeats its predecessor with probability 1/2 (an independent hash
        # bit).  Both are row-local functions of the counter hash, so shards
        # compose.
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        zipf = np.minimum((cfg.vocab * (u ** 2.2)).astype(np.int64), cfg.vocab - 1)
        repeat = ((h >> np.uint64(3)) & np.uint64(1)).astype(bool)
        repeat[:, 0] = False                       # position 0 is always fresh
        cols = np.arange(cfg.seq_len + 1, dtype=np.int64)[None, :]
        last_fresh = np.maximum.accumulate(np.where(~repeat, cols, -1), axis=1)
        toks = np.take_along_axis(zipf, last_fresh, axis=1).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "encdec":
            fh = _counter_hash(idx[:, : cfg.enc_frames] + np.uint64(0xABCDEF))
            frames = (fh >> np.uint64(11)).astype(np.float32) / float(1 << 53) - 0.5
            out["frames"] = np.broadcast_to(
                frames[:, :, None], (rows, cfg.enc_frames, cfg.d_model)
            ).astype(np.float32).copy()
        if cfg.family == "vlm":
            pos = np.broadcast_to(np.arange(cfg.seq_len, dtype=np.int32)[None],
                                  (rows, cfg.seq_len))
            out["positions"] = np.stack([pos, pos, pos])
        return out

    def batch(self, step: int, *, shard: int = 0, n_shards: int = 1) -> dict:
        """:meth:`host_batch` as tensors on the corpus's device."""
        return _to_device(self.host_batch(step, shard=shard, n_shards=n_shards), self.device)


class Prefetcher:
    """Background thread keeping ``depth`` host batches ready; :meth:`next`
    hands the next one over on the corpus's device.  Call :meth:`close`."""

    def __init__(self, corpus: SyntheticCorpus, start_step: int = 0, depth: int = 2,
                 shard: int = 0, n_shards: int = 1):
        self._corpus = corpus
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._shard, self._n_shards = shard, n_shards
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            b = self._corpus.host_batch(step, shard=self._shard, n_shards=self._n_shards)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        step, b = self._q.get()
        return step, _to_device(b, self._corpus.device)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def make_batches(cfg: DataConfig, steps: int, start: int = 0, device=None):
    corpus = SyntheticCorpus(cfg, device)
    for s in range(start, start + steps):
        yield s, corpus.batch(s)
