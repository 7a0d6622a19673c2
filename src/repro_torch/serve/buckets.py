"""Shape buckets: the serving layer's program classes (numpy only; the
port's copy of :mod:`repro.serve.buckets`).

A heterogeneous request stream would build the cached pipeline once per
distinct shape — the opposite of the zero-retrace contract.  The fix
generalizes the pipeline's own padding trick (DESIGN.md §9 pads every
*panel* to the maximal width and masks the dead columns) up one level: pad
every *request* into one of a small, fixed set of ``(m_pad, n_pad)``
program classes, so the whole stream is served by a handful of cached
programs (CUDA graphs on the card) that are all pre-warmed at startup.

**Identity-extension padding.**  Zero-padding the columns would hand the
blocked driver a rank-deficient matrix — every panel Gram containing a pad
column would be singular and its lookahead Cholesky NaN.  Instead a
request ``A`` of shape ``(m, n)`` is embedded as::

    [ A      0   ]      k = n_pad − n  pad columns
    [ 0      I_k ]      k  pad rows carrying an identity
    [ 0      0   ]      remaining row padding

The pad columns have unit norm, are exactly orthogonal to the real
columns (disjoint row support), and the padded matrix's R factor is
``[[R_A, 0], [0, I_k]]`` up to roundoff — so the caller's factor is the
top-left ``(n, n)`` block of the padded result and the pad never
perturbs it beyond ordinary fp reassociation.  The embedding needs
``m + k ≤ m_pad``, which :meth:`BucketSpec.admits` enforces.

Buckets also fix the *batch* geometry: a drain always ships exactly
``max_batch`` matrices (short drains are topped up with identity
fillers), so every drain of a bucket is the same cached program and a
re-served request's arithmetic is independent of whatever else rode its
batch.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Sequence

import numpy as np

__all__ = [
    "BucketSpec",
    "bucket_for",
    "default_buckets",
    "extract_r",
    "filler_matrix",
    "pad_request",
]


@dataclasses.dataclass(frozen=True, order=True)
class BucketSpec:
    """One program class: requests served through this bucket are padded to
    ``(m_pad, n_pad)`` and row-blocked over the server's P simulated ranks.
    """

    m_pad: int
    n_pad: int

    def __post_init__(self) -> None:
        if self.m_pad < self.n_pad or self.n_pad <= 0:
            raise ValueError(
                f"bucket must be tall-or-square with positive width, got "
                f"({self.m_pad}, {self.n_pad})"
            )

    @property
    def area(self) -> int:
        return self.m_pad * self.n_pad

    def admits(self, m: int, n: int) -> bool:
        """Can an ``(m, n)`` request be identity-extended into this bucket?
        Needs ``n ≤ n_pad`` columns and room for the ``k = n_pad − n``
        identity rows under the real rows."""
        k = self.n_pad - n
        return 0 < n <= self.n_pad and 0 < m and m + k <= self.m_pad


def default_buckets() -> tuple[BucketSpec, ...]:
    """A small power-of-two ladder covering tall-and-skinny request mixes."""
    return (
        BucketSpec(256, 32),
        BucketSpec(512, 64),
        BucketSpec(1024, 128),
    )


def bucket_for(
    buckets: Iterable[BucketSpec], m: int, n: int
) -> BucketSpec:
    """The cheapest (smallest padded area) bucket admitting ``(m, n)``."""
    fits = [b for b in buckets if b.admits(m, n)]
    if not fits:
        raise ValueError(
            f"no bucket admits a ({m}, {n}) request; configured buckets: "
            f"{sorted(buckets)} (each needs n <= n_pad and "
            "m + (n_pad - n) <= m_pad)"
        )
    return min(fits, key=lambda b: (b.area, b.n_pad, b.m_pad))


def pad_request(a: np.ndarray, spec: BucketSpec) -> np.ndarray:
    """Identity-extend ``a`` to the bucket's ``(m_pad, n_pad)`` canvas."""
    m, n = a.shape
    if not spec.admits(m, n):
        raise ValueError(f"{spec} does not admit a ({m}, {n}) request")
    k = spec.n_pad - n
    out = np.zeros((spec.m_pad, spec.n_pad), dtype=np.float32)
    out[:m, :n] = a
    if k:
        out[m:m + k, n:] = np.eye(k, dtype=np.float32)
    return out


def filler_matrix(spec: BucketSpec) -> np.ndarray:
    """The batch top-up payload: a padded identity (orthonormal columns, so
    its R is exactly I — numerically inert, never rank-deficient)."""
    return np.eye(spec.m_pad, spec.n_pad, dtype=np.float32)


def extract_r(r_pad: np.ndarray, n: int) -> np.ndarray:
    """The request's factor out of the padded result: the pad columns land
    in the trailing ``k`` rows/columns of ``R_pad``, so the caller's R is
    the top-left ``(n, n)`` block."""
    return np.asarray(r_pad)[..., :n, :n]


def block_rows(a_pad: np.ndarray, p: int) -> np.ndarray:
    """Row-block a padded ``(m_pad, n_pad)`` matrix over P simulated ranks
    → ``(P, m_local, n_pad)``."""
    m_pad, n_pad = a_pad.shape
    if m_pad % p:
        raise ValueError(f"m_pad={m_pad} not divisible by P={p} ranks")
    return a_pad.reshape(p, m_pad // p, n_pad)


def validate_buckets(buckets: Sequence[BucketSpec], p: int) -> None:
    """Server-startup validation: every bucket must row-block over P."""
    seen = set()
    for spec in buckets:
        if spec in seen:
            raise ValueError(f"duplicate bucket {spec}")
        seen.add(spec)
        if spec.m_pad % p:
            raise ValueError(
                f"{spec}: m_pad must be divisible by P={p} simulated ranks"
            )
