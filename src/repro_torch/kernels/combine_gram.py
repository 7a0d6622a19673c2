"""G = R₁ᵀR₁ + R₂ᵀR₂ of two square factors: wrapper over the Hopper kernel
``csrc/combine_gram.cu``.

The Gram-butterfly's combine of two R factors (the reference's
``ops.combine_gram``).  A CUDA tensor launches the kernel — every leading
matrix in one launch — or raises; a CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.combine_gram`.
"""
from __future__ import annotations

import torch

from . import _launch, ref
from .dispatch import launches

__all__ = ["combine_gram"]


def combine_gram(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """r1, r2: (…, n, n) float32/bfloat16 → (…, n, n) float32, exactly
    symmetric."""
    batch, m, n, _ = _launch.check("combine_gram", r1)
    if m != n:
        raise ValueError(f"combine_gram: r1 must be (..., n, n), got {tuple(r1.shape)}")
    if r2.shape != r1.shape:
        raise ValueError(
            f"combine_gram: r2 has shape {tuple(r2.shape)}, r1 {tuple(r1.shape)}; "
            "they must match"
        )
    if r2.dtype != r1.dtype:
        raise TypeError(
            f"combine_gram: r2 has dtype {r2.dtype}, r1 has {r1.dtype}; they must match"
        )
    if r2.device != r1.device:
        raise ValueError(f"combine_gram: r2 is on {r2.device}, r1 on {r1.device}")
    if not r2.is_contiguous():
        raise ValueError("combine_gram: r2 must be contiguous")
    if r1.device.type == "cpu":
        return ref.combine_gram(r1, r2)
    g = torch.empty(r1.shape, dtype=torch.float32, device=r1.device)
    _launch.launch(
        "combine_gram", r1.device, r1.data_ptr(), r2.data_ptr(), g.data_ptr(),
        int(r1.dtype == torch.bfloat16), batch, n,
    )
    launches.combine_gram += 1
    return g
