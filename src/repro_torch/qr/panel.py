"""Panel factorization on the collective engine.

A :class:`PanelFactorizer` bundles the two panel-local policies — which
local QR runs before the butterfly (``local_qr``) and how many
CholeskyQR-style re-orthonormalization passes polish the explicit Q
(``reorth``) — and runs them against the generic collective engine:
``reduce_r`` executes any :class:`~repro_torch.collective.plan.Plan` with the
QR combiner, so every survivor ends with the same final R and Q can be
formed locally as ``A R⁻¹``.

Local QR choices (the reference's keys):

  * ``"jnp"`` — Householder QR (``torch.linalg.qr``), runs no kernel;
  * ``"cqr2"`` — CholeskyQR2 R-only on the plain PyTorch versions;
  * ``"cqr2_pallas"`` — CholeskyQR2 R-only on the Hopper kernels (``gram``
    then ``fused_apply_gram(want_q=False)``).

Q's polish Gram runs on the ``gram`` kernel on the kernel routes
(``"cqr2_pallas"``, and the blocked driver with ``use_pallas``) and as a
chunked plain product elsewhere; :attr:`PanelFactorizer.kernel_gram`
decides which.  The blocked driver reduces each panel's prepared local R
and its cross products in one stacked butterfly
(:data:`FUSED_PANEL_COMBINER`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.collective.combiners import (
    QRCombiner,
    StackedCombiner,
    SumCombiner,
    posdiag,
    qr_r,
)
from repro_torch.collective.comm import Comm
from repro_torch.collective.engine import execute_plan, ft_allreduce
from repro_torch.collective.plan import Plan
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gram import gram
from repro_torch.kernels.ops import _chol_upper

__all__ = [
    "FUSED_PANEL_COMBINER",
    "PanelFactorizer",
    "chol_r",
    "chunked_gram",
    "form_q",
    "local_qr_fns",
    "resolve_local_qr",
]

_GRAM_CHUNK = 1024   # rows of one chunk of the plain polish Gram


def qr_r_cqr2(a):
    """CholeskyQR2 R factor on the plain PyTorch versions (2 sweeps)."""
    return kops.cholesky_qr2_r(a)


def qr_r_cqr2_pallas(a):
    """CholeskyQR2 R factor on the Hopper kernels (2 sweeps, one launch
    each for the whole (P, m_local, n) stack)."""
    return kops.cholesky_qr2_r(a, use_pallas=True)


local_qr_fns: dict[str, Callable] = {
    "jnp": qr_r,
    "cqr2": qr_r_cqr2,
    "cqr2_pallas": qr_r_cqr2_pallas,
}


def resolve_local_qr(local_qr: str | Callable) -> Callable:
    return local_qr_fns[local_qr] if isinstance(local_qr, str) else local_qr


def chol_r(g: torch.Tensor) -> torch.Tensor:
    """Upper-triangular R from a panel Gram matrix (all-NaN when the Gram is
    not positive definite, as the reference)."""
    return posdiag(_chol_upper(g))


def _identity(x):
    return x


# The blocked driver's one-butterfly-per-panel payload: leaf 0 is the
# panel's prepared local R (QR combine), leaf 1 its local cross products
# A_panelᵀ A_trail (sum combine).
FUSED_PANEL_COMBINER = StackedCombiner((QRCombiner(local_qr=_identity), SumCombiner()))


def chunked_gram(q: torch.Tensor) -> torch.Tensor:
    """QᵀQ in float32 without a kernel, summed over fixed 1024-row chunks:
    one batched product over a (…, chunks, rows, n) view (ragged rows
    zero-padded), then a sum over the chunk axis.  The plain analogue of
    the ``gram`` kernel's row split: one f32 product over 2^17 rows per rank
    left ‖QᵀQ − I‖ at 2.4e-5 on an H100."""
    m, n = q.shape[-2:]
    rows = min(_GRAM_CHUNK, m)
    chunks = -(-m // rows)
    q32 = q.to(torch.float32)
    if chunks * rows != m:
        q32 = torch.nn.functional.pad(q32, (0, 0, 0, chunks * rows - m))
    v = q32.reshape(q32.shape[:-2] + (chunks, rows, n))
    return (v.mT @ v).sum(dim=-3)


def _solve_r(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """q @ r⁻¹ for upper-triangular r: solve rᵀ y = qᵀ, so that the result
    comes out row-major, as the Gram kernel takes it."""
    y = torch.linalg.solve_triangular(r.mT, q.to(r.dtype).mT, upper=False)
    return y.mT.contiguous()


def form_q(a_blocks, r, comm: Comm, reorth: int = 1, *, use_pallas: bool = False):
    """Q = A·R⁻¹ locally (every survivor holds the same final R), followed by
    ``reorth`` CholeskyQR-style passes whose Gram reduction rides the
    fault-tolerant butterfly (``gram_sum`` combiner).

    The local Gram QᵀQ of each pass is :func:`chunked_gram`, or with
    ``use_pallas`` the ``gram`` kernel; both keep the f32 sums short.

    Returns ``(q, r)`` with ``r`` updated so ``Q = A·r⁻¹`` still holds after
    the polish passes.  Requires every rank to hold a correct ``r``.
    """
    local_gram = gram if use_pallas else chunked_gram
    q = _solve_r(a_blocks, r)
    for _ in range(reorth):
        g_sum, _ = ft_allreduce(local_gram(q), comm, op="gram_sum")
        r2 = chol_r(g_sum)
        q = _solve_r(q, r2)
        r = posdiag(r2 @ r)
    return q, r


@dataclasses.dataclass(frozen=True)
class PanelFactorizer:
    """Panel-local policy bundle: local QR choice + reorthogonalization.

    ``use_pallas`` marks the blocked driver's kernel route; with it (or
    with ``local_qr="cqr2_pallas"``) Q's polish Gram runs on the ``gram``
    kernel (:attr:`kernel_gram`)."""

    local_qr: str | Callable = "jnp"
    reorth: int = 1
    use_pallas: bool = False

    @property
    def kernel_gram(self) -> bool:
        return self.use_pallas or self.local_qr == "cqr2_pallas"

    def local_fn(self) -> Callable:
        return resolve_local_qr(self.local_qr)

    def combiner(self) -> QRCombiner:
        return QRCombiner(self.local_fn())

    def reduce_r(self, a_panel, comm: Comm, plan: Plan, *, fast=None):
        """Butterfly-reduce the panel to its global R: local QR (``prepare``)
        then ``QR([R_lo; R_hi])`` per level.  Returns ``(r, valid)``."""
        return execute_plan(a_panel, comm, plan, self.combiner(), fast=fast)

    def reduce_r_prepared(self, r_local, comm: Comm, plan: Plan, *, fast=None):
        """The same reduction over local R factors already computed (the
        blocked driver derives them from the lookahead Gram)."""
        return execute_plan(r_local, comm, plan, QRCombiner(local_qr=_identity), fast=fast)

    def reduce_panel_fused(self, r_local, c_local, comm: Comm, plan: Plan, *, fast=None):
        """ONE butterfly for both panel results: the stacked ``(R, Σ AᵖᵀAᵗ)``
        payload over ``plan``, whose replica copies serve both leaves.
        Returns ``((r, c_sum), valid)``, per leaf bitwise equal to
        :meth:`reduce_r_prepared` and a ``sum`` all-reduce over the same plan."""
        return execute_plan((r_local, c_local), comm, plan, FUSED_PANEL_COMBINER, fast=fast)

    def form_q(self, a_panel, r, comm: Comm):
        """Q and its R; the polish Gram runs on the ``gram`` kernel exactly
        when :attr:`kernel_gram` says so."""
        return form_q(a_panel, r, comm, self.reorth, use_pallas=self.kernel_gram)
