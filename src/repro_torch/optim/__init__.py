"""Optimizers: AdamW, PowerSGD-TSQR gradient compression, low-rank
(GaLore-style) with CholeskyQR2 bases, QR-orthogonalized momentum, and the
fault-tolerant CholeskyQR2 (:mod:`.ftqr`) that puts the latter's Gram sums
on the redundant butterfly (the reference's :mod:`repro.optim`).

Every optimizer keeps its state on the parameters' device, apart from the
step counter, which is host control flow and stays a 0-d int32 tensor on
the CPU.  :func:`state_from_reference` turns an optimizer state of the
reference (a tree of arrays) into the port's.
"""
import numpy as np
import torch

from repro_torch.collective.comm import resolve_device

from . import adamw, ftqr, lowrank, orthosgd, powersgd

__all__ = ["adamw", "ftqr", "lowrank", "orthosgd", "powersgd", "state_from_reference"]


def state_from_reference(tree, device=None):
    """The port's optimizer state for a reference state ``tree``: nested
    dicts, lists and tuples of arrays (numpy, or anything ``np.asarray``
    reads) and None, e.g. PowerSGD's ``{"q", "e"}``, the low-rank
    ``per_param`` bases and moments, AdamW's and OrthoSGD's moments.  Each
    array becomes a tensor of the same dtype and bits on ``device``
    (``None``: the card), except a ``"step"`` entry, which goes to the CPU.
    """
    device = resolve_device(device)

    def go(t, key):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v, key) for v in t)
        if t is None:
            return None
        return torch.from_numpy(np.array(t)).to("cpu" if key == "step" else device)

    return go(tree, None)
