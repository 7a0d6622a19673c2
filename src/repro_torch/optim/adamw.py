"""AdamW.

The port of :mod:`repro.optim.adamw`'s ``schedule``, ``init``,
``global_norm`` and ``update``.  The reference's ``state_shardings``
(ZeRO-1 ``PartitionSpec``s of a device mesh) has no counterpart on the
simulated-ranks backend and waits for a multi-process comm.

The step counter, the learning rate and the bias corrections are host
values (0-d float32 / int32 tensors on the CPU); the moments live on the
parameters' device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ._tree import leaves, map_params, split
from .lowrank import _bias_correction

__all__ = ["AdamWConfig", "global_norm", "init", "schedule", "update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step):
    """Linear warmup then cosine decay to ``min_lr_ratio``; a 0-d float32
    tensor on the CPU."""
    step = torch.as_tensor(step, dtype=torch.float32, device="cpu")
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": map_params(zeros, params), "v": map_params(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree):
    """‖tree‖₂ over every leaf in float32, the leaves summed in the
    reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)))


def update(cfg: AdamWConfig, params, grads, state):
    """Returns (new_params, new_state, metrics)."""
    step = int(state["step"]) + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = _bias_correction(cfg.b1, step)
    b2c = _bias_correction(cfg.b2, step)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        pf = p.to(torch.float32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), m, v

    new_p, new_m, new_v = split(map_params(upd, params, grads, state["m"], state["v"]),
                                params, 3)
    return new_p, {"m": new_m, "v": new_v, "step": torch.tensor(step, dtype=torch.int32)}, {
        "grad_norm": gn, "lr": lr,
    }
