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
    then ``fused_apply_gram(want_q=False)``); Q's polish Gram runs on the
    ``gram`` kernel too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.collective.combiners import QRCombiner, posdiag, qr_r
from repro_torch.collective.comm import Comm
from repro_torch.collective.engine import execute_plan, ft_allreduce
from repro_torch.collective.plan import Plan
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.gram import gram
from repro_torch.kernels.ops import _chol_upper

__all__ = ["PanelFactorizer", "chol_r", "form_q", "local_qr_fns", "resolve_local_qr"]


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


def _solve_r(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """q @ r⁻¹ for upper-triangular r: solve rᵀ y = qᵀ, so that the result
    comes out row-major, as the Gram kernel takes it."""
    y = torch.linalg.solve_triangular(r.mT, q.to(r.dtype).mT, upper=False)
    return y.mT.contiguous()


def form_q(a_blocks, r, comm: Comm, reorth: int = 1, *, use_pallas: bool = False):
    """Q = A·R⁻¹ locally (every survivor holds the same final R), followed by
    ``reorth`` CholeskyQR-style passes whose Gram reduction rides the
    fault-tolerant butterfly (``gram_sum`` combiner).

    The local Gram QᵀQ of each pass is the plain product, as in the
    reference, or with ``use_pallas`` the ``gram`` kernel: its row split
    keeps the f32 sums short, where one cuBLAS product over 2^17 rows per
    rank left ‖QᵀQ − I‖ at 2.4e-5 on an H100.

    Returns ``(q, r)`` with ``r`` updated so ``Q = A·r⁻¹`` still holds after
    the polish passes.  Requires every rank to hold a correct ``r``.
    """
    local_gram = gram if use_pallas else kref.gram
    q = _solve_r(a_blocks, r)
    for _ in range(reorth):
        g_sum, _ = ft_allreduce(local_gram(q), comm, op="gram_sum")
        r2 = chol_r(g_sum)
        q = _solve_r(q, r2)
        r = posdiag(r2 @ r)
    return q, r


@dataclasses.dataclass(frozen=True)
class PanelFactorizer:
    """Panel-local policy bundle: local QR choice + reorthogonalization."""

    local_qr: str | Callable = "jnp"
    reorth: int = 1

    def local_fn(self) -> Callable:
        return resolve_local_qr(self.local_qr)

    def combiner(self) -> QRCombiner:
        return QRCombiner(self.local_fn())

    def reduce_r(self, a_panel, comm: Comm, plan: Plan, *, fast=None):
        """Butterfly-reduce the panel to its global R: local QR (``prepare``)
        then ``QR([R_lo; R_hi])`` per level.  Returns ``(r, valid)``."""
        return execute_plan(a_panel, comm, plan, self.combiner(), fast=fast)

    def form_q(self, a_panel, r, comm: Comm):
        """Q and its R; the polish Gram runs on the ``gram`` kernel exactly
        when the local QR does (``local_qr="cqr2_pallas"``)."""
        return form_q(a_panel, r, comm, self.reorth,
                      use_pallas=self.local_qr == "cqr2_pallas")
