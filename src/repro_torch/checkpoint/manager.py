"""Checkpoint manager: atomic, async, step-tagged, keep-last-k.

The port of :mod:`repro.checkpoint.manager`, with its on-disk layout
(``step_XXXXXXXX/state.npz`` + ``MANIFEST.json``), so either package
restores the other's checkpoints.  Trees are flattened to ``path → array``
and written as ``.npz`` plus a JSON manifest; directories are renamed into
place only when complete, so a crash mid-write never corrupts the restore
point.  ``save(block=False)`` copies the tree to host memory before it
returns and writes on a background thread, so the caller may change its
tensors in place at once and never blocks on the filesystem.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

__all__ = ["CheckpointManager", "flatten_tree", "unflatten_like"]


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf: tensors on any device, numpy arrays, scalars.
    A bf16 tensor, which numpy cannot hold, becomes its 2-byte patterns as
    ``|V2``: what the reference's ``np.savez`` of a bf16 array writes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2"))
        return x.numpy()
    return np.array(x)


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor on ``like``'s device; a ``|V2`` entry restored
    into a bf16 leaf is read back as bf16 bit patterns."""
    if like.dtype == torch.bfloat16 and arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(like.device)
    return torch.from_numpy(arr).to(like.device)


def flatten_tree(tree) -> dict[str, np.ndarray]:
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else str(k))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        elif t is None:
            out[f"{path}#none"] = np.zeros((0,), np.int8)
        else:
            out[path] = _to_host(t)

    walk(tree, "")
    return out


def unflatten_like(template, flat: dict[str, np.ndarray]):
    """``template``'s tree with each leaf read from ``flat``: a tensor leaf
    becomes a tensor on that leaf's device, any other leaf a numpy array.
    Raises ``ValueError`` on a missing entry or a shape that differs."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, f"{path}/{i}") for i, v in enumerate(t))
        if t is None:
            if f"{path}#none" not in flat:
                raise ValueError(f"{path}: the checkpoint holds no None here")
            return None
        if path not in flat:
            raise ValueError(f"{path}: not in the checkpoint")
        arr = flat[path]
        if arr.shape != tuple(t.shape):
            raise ValueError(f"{path}: checkpoint shape {arr.shape}, template {tuple(t.shape)}")
        return _to_tensor(arr, t) if isinstance(t, torch.Tensor) else arr

    return walk(template, "")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    # ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "MANIFEST.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # ---------------------------------------------------------------
    def _write(self, step: int, flat: dict[str, np.ndarray], meta: dict):
        tmp = self._step_dir(step) + ".tmp"
        final = self._step_dir(step)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "state.npz"), **flat)
        meta = dict(meta, step=step, n_arrays=len(flat))
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def save(self, step: int, tree, meta: dict | None = None, *, block: bool = True):
        """Write ``tree`` as checkpoint ``step``.  With ``block=False`` the
        host copy is taken now and the write runs on a thread, which is
        returned; :meth:`wait` joins it."""
        flat = flatten_tree(tree)
        if block:
            with self._lock:
                self._write(step, flat, meta or {})
            return None
        self.wait()

        def go():
            with self._lock:
                self._write(step, flat, meta or {})

        self._thread = threading.Thread(target=go, daemon=True)
        self._thread.start()
        return self._thread

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, template, step: int | None = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        with np.load(os.path.join(self._step_dir(step), "state.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(self._step_dir(step), "MANIFEST.json")) as f:
            meta = json.load(f)
        return unflatten_like(template, flat), meta
