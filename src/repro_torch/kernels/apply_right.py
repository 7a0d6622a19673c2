"""Q = A·W with f32 accumulation, cast to A's dtype: wrapper over the Hopper
kernel ``csrc/apply_right.cu``.

CholeskyQR2's sweep 3 (the explicit Q).  A CUDA tensor launches the kernel
or raises; a CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.apply_right`.
"""
from __future__ import annotations

import torch

from . import _launch, ref
from .dispatch import launches

__all__ = ["apply_right"]


def apply_right(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a: (…, m, n) @ w: (…, n, k) → (…, m, k) in a's dtype."""
    batch, m, n, k = _launch.check("apply_right", a, w)
    if a.device.type == "cpu":
        return ref.apply_right(a, w)
    q = torch.empty(a.shape[:-1] + (k,), dtype=a.dtype, device=a.device)
    _launch.launch(
        "apply_right", a.device, a.data_ptr(), w.data_ptr(), q.data_ptr(),
        int(a.dtype == torch.bfloat16), batch, m, n, k,
    )
    launches.apply_right += 1
    return q
