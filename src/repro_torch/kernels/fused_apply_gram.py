"""Fused Q = A·W and G' = QᵀQ in one sweep: wrapper over the Hopper kernel
``csrc/fused_apply_gram.cu``.

CholeskyQR2's sweep 2.  With ``want_q=False`` (the R-only TSQR local QR) the
applied panel never reaches device memory.  G' is bitwise equal to
``gram(apply_right(a, w))`` of the port's own kernels, and to the
``want_q=True`` result.  A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain version :func:`repro_torch.kernels.ref.fused_apply_gram`.
``block_rows`` is :func:`~repro_torch.kernels.gram.gram`'s: the same value
gives both kernels the same row split, which their bitwise contract needs.
"""
from __future__ import annotations

import torch

from . import _launch, ref
from .dispatch import launches

__all__ = ["fused_apply_gram"]


def fused_apply_gram(a: torch.Tensor, w: torch.Tensor, *, want_q: bool = True,
                     block_rows: int | None = None):
    """a: (…, m, n), w: (…, n, k), one dtype.  Returns ``(q, g)`` with q
    (…, m, k) in a's dtype and g (…, k, k) float32 — or just ``g`` when
    ``want_q=False``."""
    batch, m, n, k = _launch.check("fused_apply_gram", a, w)
    _launch.check_rows("fused_apply_gram", block_rows)
    if a.device.type == "cpu":
        q, g = ref.fused_apply_gram(a, w)
        return (q, g) if want_q else g
    rows_per_split, splits = _launch.row_split(batch, m, k, block_rows)
    part = torch.empty((batch, splits, k, k), dtype=torch.float32, device=a.device)
    g = torch.empty(a.shape[:-2] + (k, k), dtype=torch.float32, device=a.device)
    q = torch.empty(a.shape[:-1] + (k,), dtype=a.dtype, device=a.device) if want_q else None
    _launch.launch(
        "fused_apply_gram", a.device, a.data_ptr(), w.data_ptr(),
        q.data_ptr() if want_q else None, part.data_ptr(), g.data_ptr(),
        int(a.dtype == torch.bfloat16), batch, m, n, k, rows_per_split, splits,
    )
    launches.fused_apply_gram += 1
    return (q, g) if want_q else g
