"""Argument checks, row splits and launch plumbing shared by the kernel
wrappers (``gram``, ``fused_apply_gram``, ``apply_right``,
``trailing_update``, ``panel_cross``, ``pad_cross``, ``combine_gram``)."""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["MAX_WIDTH", "check", "check_rows", "cross_split", "launch", "row_split", "strided"]

MAX_WIDTH = 512          # widest Gram / product the kernels take (as the reference)
DTYPES = (torch.float32, torch.bfloat16)
_ROWS = 32               # rows of one streamed chunk (cqr2::kRows)
_TARGET_CTAS = 4 * 132   # CTAs one launch aims for: four per H100 SM
_CROSS_TARGET = 2 * 132  # (batch, split) pairs of one cross launch: two per SM
MAX_SPLITS = 65535       # a launch's grid.y, which carries the splits


def check(op: str, a: torch.Tensor, w: torch.Tensor | None = None) -> tuple[int, int, int, int]:
    """Validate a (…, m, n) operand and an optional (…, n, k) right factor.
    Returns ``(batch, m, n, k)`` with the leading dims flattened; ``k`` is
    ``n`` without ``w``."""
    if a.ndim < 2:
        raise ValueError(f"{op}: a must be (..., m, n), got shape {tuple(a.shape)}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: tensors on {a.device} are not supported; use cuda or cpu")
    if a.dtype not in DTYPES:
        raise TypeError(f"{op}: dtype {a.dtype} not supported; use float32 or bfloat16")
    m, n = a.shape[-2:]
    k = n
    if w is not None:
        if w.dtype != a.dtype:
            raise TypeError(f"{op}: w has dtype {w.dtype}, a has {a.dtype}; they must match")
        if w.device != a.device:
            raise ValueError(f"{op}: w is on {w.device}, a on {a.device}")
        if w.shape[:-2] != a.shape[:-2] or w.shape[-2] != n:
            raise ValueError(
                f"{op}: w must be (..., {n}, k) with a's leading dims "
                f"{tuple(a.shape[:-2])}, got {tuple(w.shape)}"
            )
        k = w.shape[-1]
    if max(n, k) > MAX_WIDTH or min(m, n, k) < 1:
        raise ValueError(
            f"{op}: widths n={n}, k={k} and rows m={m} must be in [1, {MAX_WIDTH}] "
            "and >= 1 (the kernels keep at most 512 columns)"
        )
    for name, t in (("a", a), ("w", w)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    batch = math.prod(a.shape[:-2])
    if batch > 65535:
        raise ValueError(f"{op}: {batch} leading matrices exceed one launch's 65535")
    return batch, m, n, k


def check_rows(op: str, rows_per_split: int | None) -> None:
    """Validate an explicit row split: ``None`` or a positive multiple of
    the streamed chunk's 32 rows."""
    if rows_per_split is None:
        return
    if isinstance(rows_per_split, bool) or not isinstance(rows_per_split, int) or (
            rows_per_split <= 0 or rows_per_split % _ROWS):
        raise ValueError(
            f"{op}: block_rows={rows_per_split!r} must be None or a positive multiple of "
            f"{_ROWS} (the rows of one streamed chunk)"
        )


def _explicit(m: int, rows_per_split: int) -> tuple[int, int]:
    check_rows("row split", rows_per_split)
    rows = min(rows_per_split, -(-m // _ROWS) * _ROWS)
    splits = -(-m // rows)
    if splits > MAX_SPLITS:
        raise ValueError(f"block_rows={rows_per_split} splits {m} rows {splits} ways; a launch "
                         f"takes at most {MAX_SPLITS}")
    return rows, splits


def row_split(batch: int, m: int, width: int,
              rows_per_split: int | None = None) -> tuple[int, int]:
    """``(rows_per_split, splits)`` of the Gram kernels' row split.

    With no explicit ``rows_per_split``, a pure function of ``(batch, m,
    width)`` — never of the card — so that ``gram(q)`` and
    ``fused_apply_gram`` over the same rows use the same split (their
    bitwise contract) and every card gives the same bits.  An explicit
    value (a tuned or caller-chosen split: a positive multiple of 32) is
    clamped to ``m`` rounded up to 32; the contract then holds when both
    kernels are given the same value.
    """
    if rows_per_split is not None:
        return _explicit(m, rows_per_split)
    tile = 32 if width <= 32 else (64 if width <= 64 else 128)
    nt = -(-width // tile)
    pairs = nt * (nt + 1) // 2
    chunks = -(-m // _ROWS)
    splits = max(1, min(chunks, -(-_TARGET_CTAS // (batch * pairs))))
    rows_per_split = -(-chunks // splits) * _ROWS
    return rows_per_split, -(-m // rows_per_split)


def cross_split(batch: int, m: int, rows_per_split: int | None = None) -> tuple[int, int]:
    """``(rows_per_split, splits)`` of the blocked-QR kernels' row split.

    With no explicit ``rows_per_split``, a pure function of ``(batch, m)``:
    never of the card, the split width or the trailing width.  So
    ``trailing_update``'s lookahead S equals ``panel_cross`` of the stored
    A_new, ``pad_cross``'s real columns equal ``panel_cross``, a ragged
    last panel's Gram is the same whether the sweep accumulated ``b`` or
    ``b_last`` rows of S, and the fixed-shape pipeline (padded width)
    equals the eager driver (live width), all bit for bit.  An explicit
    value (a positive multiple of 32, clamped to ``m`` rounded up to 32)
    keeps those contracts when every kernel of the sweep is given it.
    Every column tile of every split is its own CTA, so the launch has at
    least ``batch * splits`` CTAs.
    """
    if rows_per_split is not None:
        return _explicit(m, rows_per_split)
    chunks = -(-m // _ROWS)
    splits = max(1, min(chunks, -(-_CROSS_TARGET // batch)))
    rows_per_split = -(-chunks // splits) * _ROWS
    return rows_per_split, -(-m // rows_per_split)


def strided(op: str, name: str, t: torch.Tensor) -> tuple[int, int]:
    """``(batch_stride, row_stride)`` of a (…, m, n) operand whose rows may
    be strided (a column slice of a wider matrix) but whose columns are
    unit-stride and whose leading dims collapse into one batch stride."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{op}: {name} must have unit column stride")
    row = t.stride(-2) if t.shape[-2] > 1 else t.shape[-1]
    if row < t.shape[-1]:
        raise ValueError(f"{op}: {name} rows overlap (row stride {row} < {t.shape[-1]})")
    lead = [(size, step) for size, step in zip(t.shape[:-2], t.stride()[:-2]) if size > 1]
    for (_, outer), (size, inner) in zip(lead, lead[1:]):
        if outer != inner * size:
            raise ValueError(f"{op}: {name}'s leading dims must collapse into one batch stride")
    batch_stride = lead[-1][1] if lead else row * t.shape[-2]
    if batch_stride < row * (t.shape[-2] - 1) + t.shape[-1]:
        raise ValueError(f"{op}: {name}'s matrices overlap in memory")
    return batch_stride, row


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s C entry on ``device``'s current stream and
    raise if the launch returned a CUDA error."""
    fn = _build.library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
