"""The blocked QR's trailing-block sweeps: wrappers over the Hopper kernels
``csrc/trailing_update.cu``, ``csrc/panel_cross.cu`` and ``csrc/pad_cross.cu``.

  * :func:`trailing_update` — ``A_new = A − Q W`` and, with
    ``next_width > 0``, the next panel's Gram and cross products
    ``S = A_new[:, :next_width]ᵀ A_new`` in the same sweep;
  * :func:`panel_cross` — the eager driver's prime, ``S = A[:, :split]ᵀ A``;
  * :func:`pad_cross` — the fixed-shape pipeline's prime: A widened to
    ``out_width`` with exact-zero columns, and S of the widened copy.

The trailing block reaches the kernels as a column slice of a wider matrix:
``a`` (and ``out``) may have strided rows, so no copy is made.  The row
split is :func:`~repro_torch.kernels._launch.cross_split`'s, a function of
``(batch, m)`` only, which makes S of :func:`trailing_update` equal
:func:`panel_cross` of the stored A_new bit for bit, and each result's real
columns independent of extra zero columns.

Each takes ``block_rows`` (a positive multiple of 32, or ``None`` for
``cross_split``'s shape-derived split): the contracts above hold between
calls given the same value, which is why the three share one tuned entry.

A CUDA tensor launches the kernel — the whole (…, m, ·) stack in one
launch — or raises; a CPU tensor takes the plain version in
:mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import math

import torch

from . import _launch, ref
from .dispatch import launches

__all__ = ["pad_cross", "panel_cross", "trailing_update"]


def _tall(op: str, a: torch.Tensor) -> tuple[int, int, int]:
    """``(batch, m, n)`` of a (…, m, n) operand with strided rows allowed."""
    if a.ndim < 2:
        raise ValueError(f"{op}: a must be (..., m, n), got shape {tuple(a.shape)}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: tensors on {a.device} are not supported; use cuda or cpu")
    if a.dtype not in _launch.DTYPES:
        raise TypeError(f"{op}: dtype {a.dtype} not supported; use float32 or bfloat16")
    m, n = a.shape[-2:]
    if not 1 <= n <= _launch.MAX_WIDTH or m < 1:
        raise ValueError(
            f"{op}: width n={n} and rows m={m} must be in [1, {_launch.MAX_WIDTH}] and >= 1 "
            "(the kernels keep at most 512 columns)"
        )
    batch = math.prod(a.shape[:-2])
    if batch > 65535:
        raise ValueError(f"{op}: {batch} leading matrices exceed one launch's 65535")
    return batch, m, n


def _like(op: str, name: str, t: torch.Tensor, a: torch.Tensor, shape: tuple) -> None:
    if t.dtype != a.dtype:
        raise TypeError(f"{op}: {name} has dtype {t.dtype}, a has {a.dtype}; they must match")
    if t.device != a.device:
        raise ValueError(f"{op}: {name} is on {t.device}, a on {a.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")


def _is_bf16(a: torch.Tensor) -> int:
    return int(a.dtype == torch.bfloat16)


def trailing_update(a: torch.Tensor, q: torch.Tensor, w: torch.Tensor, *,
                    next_width: int = 0, out: torch.Tensor | None = None,
                    block_rows: int | None = None):
    """One sweep of ``A_new = A − Q W`` (f32 arithmetic, A's dtype).

    a: (…, m, n_t), rows may be strided; q: (…, m, b); w: (…, b, n_t),
    one dtype.  ``out`` (optional, shape of ``a``, rows may be strided, must
    not overlap ``a``) receives A_new.  Returns ``a_new`` — or
    ``(a_new, s)`` with ``s`` (…, next_width, n_t) float32 when
    ``next_width > 0``.
    """
    op = "trailing_update"
    batch, m, nt = _tall(op, a)
    b = q.shape[-1] if q.ndim >= 2 else 0
    _like(op, "q", q, a, a.shape[:-1] + (b,))
    _like(op, "w", w, a, a.shape[:-2] + (b, nt))
    if not 1 <= b <= _launch.MAX_WIDTH:
        raise ValueError(f"{op}: panel width b={b} must be in [1, {_launch.MAX_WIDTH}]")
    if not 0 <= next_width <= nt:
        raise ValueError(f"{op}: next_width={next_width} must be in [0, n_t={nt}]")
    if out is not None:
        _like(op, "out", out, a, a.shape)
    _launch.check_rows(op, block_rows)
    if a.device.type == "cpu":
        res = ref.trailing_update(a, q, w, next_width=next_width)
        if out is None:
            return res
        out.copy_(res[0] if next_width else res)
        return (out, res[1]) if next_width else out
    for name, t in (("q", q), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    a_bs, lda = _launch.strided(op, "a", a)
    if out is None:
        out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    o_bs, ldo = _launch.strided(op, "out", out)
    rows_per_split, splits = _launch.cross_split(batch, m, block_rows)
    part = s = None
    if next_width:
        part = torch.empty((batch, splits, next_width, nt), dtype=torch.float32, device=a.device)
        s = torch.empty(a.shape[:-2] + (next_width, nt), dtype=torch.float32, device=a.device)
    _launch.launch(
        op, a.device, a.data_ptr(), q.data_ptr(), w.data_ptr(), out.data_ptr(),
        part.data_ptr() if next_width else None, s.data_ptr() if next_width else None,
        _is_bf16(a), batch, m, b, nt, next_width, lda, a_bs, ldo, o_bs, rows_per_split, splits,
    )
    launches.trailing_update += 1
    return (out, s) if next_width else out


def panel_cross(a: torch.Tensor, *, split: int, block_rows: int | None = None) -> torch.Tensor:
    """``S = A[:, :split]ᵀ A`` in one sweep, float32.  a: (…, m, n), rows
    may be strided → (…, split, n)."""
    op = "panel_cross"
    batch, m, n = _tall(op, a)
    if not 0 < split <= n:
        raise ValueError(f"{op}: split={split} must be in [1, n={n}]")
    _launch.check_rows(op, block_rows)
    if a.device.type == "cpu":
        return ref.panel_cross(a, split=split)
    a_bs, lda = _launch.strided(op, "a", a)
    rows_per_split, splits = _launch.cross_split(batch, m, block_rows)
    part = torch.empty((batch, splits, split, n), dtype=torch.float32, device=a.device)
    s = torch.empty(a.shape[:-2] + (split, n), dtype=torch.float32, device=a.device)
    _launch.launch(
        op, a.device, a.data_ptr(), part.data_ptr(), s.data_ptr(), _is_bf16(a), batch, m, n,
        split, lda, a_bs, rows_per_split, splits,
    )
    launches.panel_cross += 1
    return s


def pad_cross(a: torch.Tensor, *, split: int, out_width: int, block_rows: int | None = None):
    """Widen A to ``out_width`` with exact-zero columns and compute
    ``S = A_pad[:, :split]ᵀ A_pad`` in the same sweep.  a: (…, m, n), rows
    may be strided → ``(a_pad (…, m, out_width) in a's dtype,
    s (…, split, out_width) float32)``."""
    op = "pad_cross"
    batch, m, n = _tall(op, a)
    if not 0 < split <= n <= out_width <= _launch.MAX_WIDTH:
        raise ValueError(
            f"{op}: need 0 < split={split} <= n={n} <= out_width={out_width} "
            f"<= {_launch.MAX_WIDTH}"
        )
    _launch.check_rows(op, block_rows)
    if a.device.type == "cpu":
        return ref.pad_cross(a, split=split, out_width=out_width)
    a_bs, lda = _launch.strided(op, "a", a)
    rows_per_split, splits = _launch.cross_split(batch, m, block_rows)
    a_pad = torch.empty(a.shape[:-1] + (out_width,), dtype=a.dtype, device=a.device)
    part = torch.empty((batch, splits, split, out_width), dtype=torch.float32, device=a.device)
    s = torch.empty(a.shape[:-2] + (split, out_width), dtype=torch.float32, device=a.device)
    _launch.launch(
        op, a.device, a.data_ptr(), a_pad.data_ptr(), part.data_ptr(), s.data_ptr(),
        _is_bf16(a), batch, m, n, split, out_width, lda, a_bs, rows_per_split, splits,
    )
    launches.pad_cross += 1
    return a_pad, s
