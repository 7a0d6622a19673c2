"""Low-rank-projected optimizer (GaLore-style) with distributed-CQR2 bases.

The port of :mod:`repro.optim.lowrank`: every ``refresh_every`` steps the
projection basis of each 2D parameter's gradient is re-orthonormalized
with CholeskyQR2 (:func:`gram_cqr2_q`, or with ``ft_shards > 1`` the
fault-tolerant twin :func:`repro_torch.optim.ftqr.ft_cqr2_q`, whose Gram
sums ride the redundant butterfly).  Adam moments then live in the
rank-r projected space: 8·m·r bytes instead of 8·m·n.

Applied to 2D params whose smaller dim ≥ ``min_dim``; everything else
falls through to dense Adam behavior.

The step counter is host control flow (it picks the refresh steps), so it
is a 0-d int32 tensor on the CPU; the moments and bases live on the
parameters' device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.ops import _chol_upper

from ._tree import map_params, split

__all__ = ["LowRankConfig", "gram_cqr2_q", "init", "sketch", "update"]


@dataclasses.dataclass(frozen=True)
class LowRankConfig:
    rank: int = 32
    refresh_every: int = 20
    min_dim: int = 256
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    scale: float = 0.25            # GaLore alpha
    # >1 routes the basis-refresh CQR2 Gram sums through the fault-tolerant
    # butterfly over this many row shards (repro_torch.optim.ftqr); 0/1
    # keeps the plain contraction.
    ft_shards: int = 0


def _eligible(p):
    return p.ndim >= 2 and min(p.shape[-2:]) >= 1 and p.shape[-1] >= 1


def _orient(g):
    """Tall orientation: rows = the longer of the final two dims."""
    if g.shape[-2] >= g.shape[-1]:
        return g, False
    return g.mT, True


def _gram_ridge(g):
    """Shifted-Cholesky regularizer: real training momenta are routinely
    rank-deficient (unseen vocab rows, dead experts, zero grads), which
    makes the exact Gram singular.  A relative ridge keeps the
    factorization finite; the second CQR2 round restores orthogonality on
    the non-degenerate subspace, and an all-zero input maps to an all-zero
    Q instead of NaN."""
    n = g.shape[-1]
    tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return g + (1e-6 * tr / n + 1e-30) * torch.eye(n, dtype=g.dtype, device=g.device)


# The rows of one block of :func:`_gram`.
GRAM_ROWS = 512


def _gram(x):
    """xᵀx (…, n, n) of ``x`` (…, m, n) in float32, as the sum of the Grams
    of blocks of ``GRAM_ROWS`` rows (the last padded with zero rows, which
    add nothing).  cuBLAS accumulates each entry of a one-product f32 Gram
    in one chain along all m rows; at olmo-1b's tied embedding (50 304 rows)
    that Gram's error, 7.7e-7, passes its least eigenvalue, 2.2e-8, and
    CholeskyQR2 goes NaN, where summed blocks of 393 rows read 2.8e-9 on an
    H100 (``tests/orthosgd_witness.py grams``).  At most ``GRAM_ROWS`` rows
    it is the one product."""
    m = x.shape[-2]
    if m <= GRAM_ROWS:
        return x.mT @ x
    pad = (-m) % GRAM_ROWS
    if pad:
        x = torch.cat([x, x.new_zeros((*x.shape[:-2], pad, x.shape[-1]))], dim=-2)
    xb = x.reshape(*x.shape[:-2], (m + pad) // GRAM_ROWS, GRAM_ROWS, x.shape[-1])
    return (xb.mT @ xb).sum(-3)


def _cqr_round(x, g):
    """One CholeskyQR round from the Gram ``g`` of ``x``: x·R⁻¹ with
    R = chol(ridge(g)), as the solve Rᵀ yᵀ = xᵀ.  A Gram that is not
    positive definite gives NaN, as the reference's Cholesky does."""
    r = _chol_upper(_gram_ridge(g))
    return torch.linalg.solve_triangular(r.mT, x.mT, upper=False).mT


def gram_cqr2_q(a):
    """CholeskyQR2 Q factor of ``a`` (…, m, n) in float32: two rounds for
    Householder-grade orthogonality."""
    def round_(x):
        return _cqr_round(x, _gram(x))

    return round_(round_(a.to(torch.float32)))


def sketch(shape, device):
    """The basis refresh's Gaussian sketch Ω.  The reference draws it from
    one fixed key, so every refresh of a shape sees the same Ω; here it is
    drawn from a CPU generator seeded 0 and moved to ``device``, so the
    card and the CPU start from the same Ω."""
    gen = torch.Generator().manual_seed(0)
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def _project_basis(g, rank, ft_shards: int = 0):
    """Orthonormal (n, r) right basis of g (m, n) via CQR2 of gᵀ·Ω."""
    omega = sketch((*g.shape[:-2], g.shape[-2], rank), g.device)
    panel = g.mT.to(torch.float32) @ omega                       # (n, r)
    if ft_shards > 1:
        from .ftqr import ft_cqr2_q

        return ft_cqr2_q(panel, ft_shards)
    return gram_cqr2_q(panel)


def _bias_correction(b: float, step: int) -> float:
    """1 − b^step in float32, as the reference computes it."""
    return float(1 - torch.tensor(b, dtype=torch.float32) ** step)


def init(params, cfg: LowRankConfig):
    def one(p):
        zeros = dict(dtype=torch.float32, device=p.device)
        if not _eligible(p) or min(p.shape[-2:]) < cfg.min_dim:
            return {"m": torch.zeros(p.shape, **zeros), "v": torch.zeros(p.shape, **zeros),
                    "basis": None}
        m, n = p.shape[-2:]
        r = min(cfg.rank, n)
        lead = tuple(p.shape[:-2])
        return {"m": torch.zeros((*lead, m, r), **zeros),
                "v": torch.zeros((*lead, m, r), **zeros),
                "basis": torch.zeros((*lead, n, r), **zeros)}

    return {"per_param": map_params(one, params), "step": torch.zeros((), dtype=torch.int32)}


def update(cfg: LowRankConfig, params, grads, state):
    step = int(state["step"]) + 1
    b1c = _bias_correction(cfg.b1, step)
    b2c = _bias_correction(cfg.b2, step)
    refresh = (step % cfg.refresh_every) == 1

    def one(p, g, st):
        gf = g.to(torch.float32)
        if st["basis"] is None:
            m_ = cfg.b1 * st["m"] + (1 - cfg.b1) * gf
            v_ = cfg.b2 * st["v"] + (1 - cfg.b2) * gf * gf
            delta = (m_ / b1c) / (torch.sqrt(v_ / b2c) + cfg.eps)
            newp = (p.to(torch.float32) - cfg.lr * delta).to(p.dtype)
            return newp, {"m": m_, "v": v_, "basis": None}
        basis = (_project_basis(gf, st["basis"].shape[-1], cfg.ft_shards) if refresh
                 else st["basis"])
        gr = gf @ basis                                  # (m, r) projected
        m_ = cfg.b1 * st["m"] + (1 - cfg.b1) * gr
        v_ = cfg.b2 * st["v"] + (1 - cfg.b2) * gr * gr
        dr = (m_ / b1c) / (torch.sqrt(v_ / b2c) + cfg.eps)
        delta = cfg.scale * (dr @ basis.mT)
        newp = (p.to(torch.float32) - cfg.lr * delta).to(p.dtype)
        return newp, {"m": m_, "v": v_, "basis": basis}

    new_p, new_s = split(map_params(one, params, grads, state["per_param"]), params, 2)
    return new_p, {"per_param": new_s, "step": torch.tensor(step, dtype=torch.int32)}
