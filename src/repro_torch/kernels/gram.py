"""G = AᵀA of tall-skinny blocks: wrapper over the Hopper kernel ``csrc/gram.cu``.

CholeskyQR2's sweep 1.  A CUDA tensor launches the kernel — the whole
(…, m, n) stack in one launch — or raises; a CPU tensor takes the plain
version :func:`repro_torch.kernels.ref.gram`.  ``block_rows`` (a positive
multiple of 32, or ``None`` for the kernel's shape-derived split) sets the
rows each split sums; :func:`fused_apply_gram` given the same value sums
the same rows, so ``gram(q)`` stays bitwise equal to its G'.
"""
from __future__ import annotations

import torch

from . import _launch, ref
from .dispatch import launches

__all__ = ["gram"]


def gram(a: torch.Tensor, *, block_rows: int | None = None) -> torch.Tensor:
    """G = AᵀA, float32.  a: (…, m, n) float32/bfloat16 → (…, n, n) float32."""
    batch, m, n, _ = _launch.check("gram", a)
    _launch.check_rows("gram", block_rows)
    if a.device.type == "cpu":
        return ref.gram(a)
    rows_per_split, splits = _launch.row_split(batch, m, n, block_rows)
    part = torch.empty((batch, splits, n, n), dtype=torch.float32, device=a.device)
    g = torch.empty(a.shape[:-2] + (n, n), dtype=torch.float32, device=a.device)
    _launch.launch(
        "gram", a.device, a.data_ptr(), part.data_ptr(), g.data_ptr(),
        int(a.dtype == torch.bfloat16), batch, m, n, rows_per_split, splits,
    )
    launches.gram += 1
    return g
