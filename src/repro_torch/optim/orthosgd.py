"""QR-orthogonalized momentum ("Muon-flavoured" via QR, not Newton-Schulz).

The port of :mod:`repro.optim.orthosgd`.  For each 2D parameter: momentum
M ← β·M + G; the update direction is the orthonormal factor Q of M's tall
orientation, computed with the CholeskyQR2 the low-rank optimizer uses
(or its fault-tolerant twin with ``ft_shards > 1``).  1D params fall back
to SGD+momentum.
"""
from __future__ import annotations

import dataclasses

import torch

from ._tree import map_params, split
from .lowrank import gram_cqr2_q

__all__ = ["OrthoSGDConfig", "init", "update"]


@dataclasses.dataclass(frozen=True)
class OrthoSGDConfig:
    lr: float = 0.02
    momentum: float = 0.95
    nesterov: bool = True
    weight_decay: float = 0.0
    # >1 routes the CQR2 Gram sums through the fault-tolerant butterfly
    # over this many row shards (repro_torch.optim.ftqr); 0/1 keeps the
    # plain contraction.
    ft_shards: int = 0


def init(params):
    return {
        "m": map_params(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params),
        "step": torch.zeros((), dtype=torch.int32),
    }


def _orth_update(m, ft_shards: int = 0):
    tall = m.shape[-2] >= m.shape[-1]
    x = m if tall else m.mT
    if ft_shards > 1:
        from .ftqr import ft_cqr2_q

        q = ft_cqr2_q(x, ft_shards)
    else:
        q = gram_cqr2_q(x)
    q = q if tall else q.mT
    # Muon-style shape rescale so update RMS matches across aspect ratios
    # (float32, as the reference computes it)
    out_scale = torch.tensor(max(m.shape[-2], m.shape[-1]) / m.shape[-1],
                             dtype=torch.float32).sqrt()
    return q * float(out_scale)


def update(cfg: OrthoSGDConfig, params, grads, state):
    step = int(state["step"]) + 1

    def one(p, g, m):
        gf = g.to(torch.float32)
        m_ = cfg.momentum * m + gf
        eff = gf + cfg.momentum * m_ if cfg.nesterov else m_
        if p.ndim >= 2 and min(p.shape[-2:]) >= 2:
            d = _orth_update(eff, cfg.ft_shards)
        else:
            d = eff
        pf = p.to(torch.float32)
        newp = pf - cfg.lr * (d + cfg.weight_decay * pf)
        return newp.to(p.dtype), m_

    new_p, new_m = split(map_params(one, params, grads, state["m"]), params, 2)
    return new_p, {"m": new_m, "step": torch.tensor(step, dtype=torch.int32)}
