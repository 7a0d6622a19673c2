"""Plain PyTorch versions of the CholeskyQR2, blocked-QR and Gram-combine
kernels.

The CPU tests run these, a kernel wrapper takes one only for a tensor on the
CPU, and the card checks compare each kernel against its version here.
float32 products run in full float32: a CUDA tensor would need
``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default), which
the card checks set explicitly.
"""
from __future__ import annotations

import torch

__all__ = [
    "gram",
    "apply_right",
    "fused_apply_gram",
    "cholesky_qr",
    "cholesky_qr2",
    "trailing_update",
    "panel_cross",
    "pad_cross",
    "combine_gram",
]


def gram(a: torch.Tensor) -> torch.Tensor:
    """G = AᵀA accumulated in float32.  a: (..., m, n) → (..., n, n) f32."""
    a32 = a.to(torch.float32)
    return a32.mT @ a32


def apply_right(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A @ W with float32 accumulation, result in A's dtype.  w: (..., n, k)."""
    return (a.to(torch.float32) @ w.to(torch.float32)).to(a.dtype)


def fused_apply_gram(a: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Q = A @ W and G' = QᵀQ of the *stored* (cast) Q."""
    q = apply_right(a, w)
    return q, gram(q)


def panel_cross(a: torch.Tensor, *, split: int) -> torch.Tensor:
    """S = A[:, :split]ᵀ A accumulated in float32.  a: (..., m, n) → (..., split, n)."""
    a32 = a.to(torch.float32)
    return a32[..., :split].mT @ a32


def trailing_update(a: torch.Tensor, q: torch.Tensor, w: torch.Tensor, *,
                    next_width: int = 0):
    """A_new = A − Q W in float32, stored in A's dtype; with ``next_width > 0``
    also the lookahead S = A_new[:, :next_width]ᵀ A_new of the *stored*
    (cast) rows.  a: (..., m, n_t), q: (..., m, b), w: (..., b, n_t)."""
    upd = q.to(torch.float32) @ w.to(torch.float32)
    a_new = (a.to(torch.float32) - upd).to(a.dtype)
    if not next_width:
        return a_new
    return a_new, panel_cross(a_new, split=next_width)


def pad_cross(a: torch.Tensor, *, split: int, out_width: int):
    """Widen A with zero columns to ``out_width`` and return it with the
    :func:`panel_cross` of the widened copy.

    S is :func:`panel_cross` of the unpadded A written into the real columns
    of a zero S: the same function, since A's pad columns are zero, and the
    real columns then equal ``panel_cross(a)`` bit for bit on any BLAS, the
    contract the card's kernels keep (``csrc/cross_tiles.cuh``).  A product
    of the widened copy would leave the summation order to the BLAS, which
    may pick another one for another width.
    """
    n = a.shape[-1]
    a_pad = torch.nn.functional.pad(a, (0, out_width - n))
    s = torch.zeros(a.shape[:-2] + (split, out_width), dtype=torch.float32, device=a.device)
    s[..., :n] = panel_cross(a, split=split)
    return a_pad, s


def combine_gram(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """G = R1ᵀR1 + R2ᵀR2 in float32: the Gram-combine of two factors."""
    return gram(r1) + gram(r2)


def _posdiag(r: torch.Tensor) -> torch.Tensor:
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    s = torch.where(d < 0, -1.0, 1.0).to(r.dtype)
    return r * s[..., :, None]


def cholesky_qr(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One CholeskyQR round: Q = A·R⁻¹ with R = chol(AᵀA)ᵀ."""
    r = torch.linalg.cholesky(gram(a)).mT
    eye = torch.eye(r.shape[-1], dtype=r.dtype, device=r.device)
    rinv = torch.linalg.solve_triangular(r, eye, upper=True)
    return apply_right(a, rinv), r


def cholesky_qr2(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CholeskyQR2 — two rounds."""
    q1, r1 = cholesky_qr(a)
    q, r2 = cholesky_qr(q1)
    return q, _posdiag(r2 @ r1)
