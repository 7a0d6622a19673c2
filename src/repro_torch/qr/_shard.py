"""Shared scaffold of the cached per-rank programs of the mesh routes.

The four mesh entry points (TSQR, the Gram-butterfly TSQR, and the blocked
driver's pipeline and general paths) run a per-rank body on this rank's
``(m_local, n)`` block and return per-rank outputs (``r[None]``,
``valid[None]``, the local Q rows).  The port's counterpart of the
reference's ``shard_compile`` is :func:`repro_torch.replay.run` with
``capture=False``: one program per hashable statics key and input
signature, counted as one trace when it is built and run eagerly on every
call.

Traffic accounting (:mod:`repro_torch.kernels.traffic`): kernel calls made
inside a cached per-rank body note their bytes only on the call that
builds the program, so a warm repeat records nothing, as the reference's
shard bodies note theirs at trace time only.  The pipeline wrapper notes
its own per-call totals.
"""
from __future__ import annotations

import torch

__all__ = ["dummy_q"]


def dummy_q(a_blk: torch.Tensor) -> torch.Tensor:
    """Zero-row placeholder returned when the explicit Q is not wanted (the
    body's output arity does not depend on ``compute_q``)."""
    return a_blk.new_zeros((0, a_blk.shape[-1]))
