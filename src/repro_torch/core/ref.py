"""Numpy oracles for the TSQR variants — ground truth for the test-suite.

A copy of :mod:`repro.core.ref`.  Everything here is deliberately naive and
sequential: plain ``np.linalg.qr`` plus an explicit walk of the reduction
tree.  The port must agree with these to tolerance on every valid rank.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "posdiag",
    "qr_r",
    "qr_full",
    "tree_tsqr",
    "butterfly_tsqr",
    "random_tall_skinny",
]


def posdiag(r: np.ndarray) -> np.ndarray:
    d = np.diagonal(r, axis1=-2, axis2=-1)
    s = np.where(d < 0, -1.0, 1.0).astype(r.dtype)
    return r * s[..., :, None]


def qr_r(a: np.ndarray) -> np.ndarray:
    """R factor with non-negative diagonal (unique for full-rank A)."""
    return posdiag(np.linalg.qr(a, mode="r"))


def qr_full(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    q, r = np.linalg.qr(a, mode="reduced")
    d = np.diagonal(r, axis1=-2, axis2=-1)
    s = np.where(d < 0, -1.0, 1.0).astype(r.dtype)
    return q * s[..., None, :], r * s[..., :, None]


def tree_tsqr(blocks: np.ndarray) -> np.ndarray:
    """Paper Alg. 1 walked sequentially: blocks (P, m_local, n) → R (n, n)."""
    rs = [qr_r(b) for b in blocks]
    while len(rs) > 1:
        nxt = []
        for i in range(0, len(rs), 2):
            nxt.append(qr_r(np.concatenate([rs[i], rs[i + 1]], axis=0)))
        rs = nxt
    return rs[0]


def butterfly_tsqr(blocks: np.ndarray) -> np.ndarray:
    """Paper Alg. 2 (fault-free) walked sequentially: returns (P, n, n) —
    every rank's final R.  All slices must be identical."""
    p = blocks.shape[0]
    rs = np.stack([qr_r(b) for b in blocks])
    s = 0
    while (1 << s) < p:
        new = np.empty_like(rs)
        for r_id in range(p):
            buddy = r_id ^ (1 << s)
            lo, hi = (r_id, buddy) if (r_id >> s) & 1 == 0 else (buddy, r_id)
            new[r_id] = qr_r(np.concatenate([rs[lo], rs[hi]], axis=0))
        rs = new
        s += 1
    return rs


def random_tall_skinny(
    rng: np.random.Generator,
    p: int,
    m_local: int,
    n: int,
    dtype=np.float32,
    cond: float | None = None,
) -> np.ndarray:
    """(P, m_local, n) blocks of a full-rank tall-skinny matrix.

    ``cond`` optionally fixes the condition number (log-uniform singular
    values) — the CQR2 kernels are only certified for κ ≲ 1/√ε per round.
    """
    m = p * m_local
    a = rng.standard_normal((m, n)).astype(np.float64)
    if cond is not None:
        u, _, vt = np.linalg.svd(a, full_matrices=False)
        sv = np.logspace(0, -np.log10(cond), n)
        a = (u * sv) @ vt
    return a.reshape(p, m_local, n).astype(dtype)
