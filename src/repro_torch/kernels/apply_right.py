"""Q = A·W with f32 accumulation, cast to A's dtype: wrapper over the Hopper
kernel ``csrc/apply_right.cu``.

CholeskyQR2's sweep 3 (the explicit Q).  A CUDA tensor launches the kernel
or raises; a CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.apply_right`.

Its row tiling is fixed when the kernel is built: each tile is
:func:`fixed_rows` rows (256, 512 or 1024 by the column tile the widths
choose, a template constant of ``csrc/apply_right.cu``), and no rows are
summed across CTAs, so any tiling gives the same bits.  The kernel cannot
take a row count at run time without a new build, so ``block_rows`` is
validated as the other kernels' (``None`` or a positive multiple of 32)
and does not change the launch; its autotune entry has the fixed tiling as
its one legal candidate.
"""
from __future__ import annotations

import torch

from . import _launch, ref
from .dispatch import launches

__all__ = ["apply_right", "fixed_rows"]

_SLAB_BYTES = 64 << 10   # W's slab in shared memory (kSlabBytes)


def fixed_rows(n: int, k: int) -> int:
    """Rows of one tile of ``csrc/apply_right.cu`` for an (n, k) W: the
    column tile T is 128, 64 or 32 (``cqr2::tile_for(k)``, halved until W's
    slab of ``n`` rounded up to T/2 rows fits 64 KiB), and a tile is
    ``Tile<T>::BM`` = 256 · 128 / T rows."""
    tile = 32 if k <= 32 else (64 if k <= 64 else 128)

    def fits(t: int) -> bool:
        depth = t // 2
        return -(-n // depth) * depth * t * 4 <= _SLAB_BYTES

    if tile == 128 and fits(128):
        t = 128
    elif tile >= 64 and fits(64):
        t = 64
    else:
        t = 32
    return 256 * 128 // t


def apply_right(a: torch.Tensor, w: torch.Tensor, *,
                block_rows: int | None = None) -> torch.Tensor:
    """a: (…, m, n) @ w: (…, n, k) → (…, m, k) in a's dtype."""
    batch, m, n, k = _launch.check("apply_right", a, w)
    _launch.check_rows("apply_right", block_rows)
    if a.device.type == "cpu":
        return ref.apply_right(a, w)
    q = torch.empty(a.shape[:-1] + (k,), dtype=a.dtype, device=a.device)
    _launch.launch(
        "apply_right", a.device, a.data_ptr(), w.data_ptr(), q.data_ptr(),
        int(a.dtype == torch.bfloat16), batch, m, n, k,
    )
    launches.apply_right += 1
    return q
