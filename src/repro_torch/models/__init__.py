"""Model zoo, the port of :mod:`repro.models`: the dense / MoE / VLM
transformers (:mod:`.transformer`), Mamba2 SSD (:mod:`.ssm`), the Zamba2
hybrid (:mod:`.hybrid`) and Whisper enc-dec (:mod:`.encdec`), all behind the
uniform :mod:`repro_torch.models.api` surface.

:func:`params_from_reference` and :func:`params_to_reference` carry a
parameter tree (or a decode cache) across, bit for bit: bf16 arrays, which
``torch.from_numpy`` refuses, travel as their 16-bit patterns.
"""
import numpy as np
import torch

from repro_torch.collective.comm import resolve_device

from . import api

__all__ = ["api", "params_from_reference", "params_to_reference"]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def params_from_reference(tree, device=None):
    """The port's tree for a reference tree of arrays (numpy, or anything
    ``np.asarray`` reads): the same nesting, each leaf a tensor of the same
    dtype and bits on ``device`` (None: the card).  A 0-d integer leaf (a
    cache's ``len``) stays on the CPU."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
        t = torch.from_numpy(np.array(a))
        return t if t.dim() == 0 and not t.is_floating_point() else t.to(device)

    return _map(leaf, tree)


def params_to_reference(params):
    """numpy arrays for a tree of tensors, the same nesting, dtypes and bits
    (bf16 as ``ml_dtypes.bfloat16``, the dtype JAX reads)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return _map(leaf, params)
