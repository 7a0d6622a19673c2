"""Uniform model API over the families: init / loss / prefill / decode, the
port of :mod:`repro.models.api`.

  * ``init(generator, cfg, device=None)``  → params (the reference's tree)
  * ``param_specs(cfg)``                   → the same tree on the meta device
  * ``loss_fn(params, batch, cfg)``        → scalar  (train step body)
  * ``prefill / decode_step``              → serving step bodies
  * ``batch_specs(cfg, kind, b, s)``       → input tensors on the meta device
  * ``synth_batch(generator, cfg, ...)``   → concrete small batch
  * :class:`LM`                            → an ``nn.Module`` holding the tree

Entry points that make tensors run on the card unless the caller passes
``device="cpu"``; the others run where their inputs are.  Every registered
architecture routes here: the dense, MoE and VLM transformers, Mamba2
(``ssm``), Zamba2 (``hybrid``) and Whisper (``encdec``, whose batches carry
``frames``).
"""
from __future__ import annotations

import torch

from repro_torch.collective.comm import resolve_device

from . import encdec, frontends, hybrid, ssm, transformer
from .layers import generator_on

__all__ = [
    "LM", "module_for", "init", "param_specs", "loss_fn", "forward",
    "prefill", "decode_step", "init_decode_cache", "decode_cache_specs",
    "batch_specs", "synth_batch",
]

_FAMILIES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": ssm,
    "hybrid": hybrid,
    "encdec": encdec,
}


def module_for(cfg):
    return _FAMILIES[cfg.family]


def init(generator, cfg, device=None):
    return module_for(cfg).init(generator, cfg, device)


def param_specs(cfg):
    """The parameter tree's shapes and dtypes, as tensors on the meta device."""
    return init(None, cfg, device="meta")


def forward(params, batch, cfg):
    mod = module_for(cfg)
    if cfg.family == "encdec":
        return mod.forward(params, batch["tokens"], cfg, frames=batch["frames"])
    return mod.forward(params, batch["tokens"], cfg, batch.get("positions"))


def loss_fn(params, batch, cfg):
    """Weighted next-token loss.  ``batch['loss_weight']`` (B,) optionally
    down-weights rows — the BLANK-semantics path where a failed replica's
    contribution is dropped and the rest rescaled."""
    logits = forward(params, batch, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, batch["labels"][..., None].long())[..., 0]
    nll = lse - ll                                   # (B, S)
    w = batch.get("loss_weight")
    if w is None:
        loss = nll.mean()
    else:
        wf = w[:, None].to(nll.dtype)
        loss = (nll * wf).sum() / torch.clamp_min((wf * torch.ones_like(nll)).sum(), 1.0)
    return loss + 1e-4 * torch.square(lse).mean()


def prefill(params, batch, cfg, s_max=None):
    mod = module_for(cfg)
    if cfg.family == "encdec":
        return mod.prefill(params, batch["tokens"], cfg, frames=batch["frames"], s_max=s_max)
    return mod.prefill(params, batch["tokens"], cfg, positions=batch.get("positions"),
                       s_max=s_max)


def decode_step(params, cache, token, cfg):
    return module_for(cfg).decode_step(params, cache, token, cfg)


def init_decode_cache(cfg, batch: int, s_max: int, dtype=None, device=None):
    return module_for(cfg).init_decode_cache(cfg, batch, s_max, dtype, device)


def decode_cache_specs(cfg, batch: int, s_max: int):
    return init_decode_cache(cfg, batch, s_max, device="meta")


# ---------------------------------------------------------------------------
# Input specs / synthetic batches per shape cell
# ---------------------------------------------------------------------------

def batch_specs(cfg, kind: str, batch: int, seq: int) -> dict:
    """Input tensors on the meta device for a (train | prefill | decode) step."""
    def tok(s):
        return torch.empty((batch, s), dtype=torch.int32, device="meta")

    if kind == "train":
        out = {"tokens": tok(seq), "labels": tok(seq)}
    elif kind == "prefill":
        out = {"tokens": tok(seq)}
    elif kind == "decode":
        out = {"tokens": tok(1)}
    else:
        raise ValueError(kind)
    if cfg.family == "encdec" and kind in ("train", "prefill"):
        out["frames"] = frontends.audio_frames_spec(cfg, batch)
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        out["positions"] = frontends.mrope_positions_spec(cfg, batch, seq)
    return out


def synth_batch(generator, cfg, kind: str, batch: int, seq: int, device=None) -> dict:
    """A concrete random batch matching :func:`batch_specs`, on ``device``
    (None: the card), drawn from ``generator`` (a ``torch.Generator`` on
    that device, or an int seed)."""
    device = resolve_device(device)
    gen = generator_on(generator, device)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=device,
                           dtype=torch.int32)
    if kind == "train":
        out = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    elif kind == "prefill":
        out = {"tokens": tokens}
    elif kind == "decode":
        out = {"tokens": tokens[:, :1]}
    else:
        raise ValueError(kind)
    if cfg.family == "encdec" and kind in ("train", "prefill"):
        out["frames"] = frontends.audio_frames(gen, cfg, batch)
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        span = (8, 8 + min(16, seq // 2)) if seq >= 24 else None
        out["positions"] = frontends.mrope_positions(
            cfg, batch, seq, image_span=span, grid=(4, 4), device=device)
    return out


# ---------------------------------------------------------------------------
# The parameters as an nn.Module
# ---------------------------------------------------------------------------

class LM(torch.nn.Module):
    """A model's parameter tree registered as ``nn.Parameter``s (a None
    leaf, the hybrid's absent tail, stays None).

    ``LM(cfg)`` draws the tree with :func:`init` (seed 0 on the card unless
    ``generator``/``device`` say otherwise); ``LM(cfg, params)`` adopts a
    given tree.  :meth:`tree` hands back the tree in the reference's layout
    (``{"embed", "units": tuple of stacked dicts, "final_norm"}``), its
    leaves the module's parameters, so optimizers that walk trees and
    ``parameters()`` see the same tensors.
    """

    def __init__(self, cfg, params=None, *, generator=0, device=None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init(generator, cfg, device)
        self._layout = self._register(params, "")

    def _register(self, t, path):
        if isinstance(t, dict):
            return {k: self._register(v, f"{path}__{k}" if path else k) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(self._register(v, f"{path}__{i}") for i, v in enumerate(t))
        if t is None:
            return None
        self.register_parameter(path, torch.nn.Parameter(t, requires_grad=t.is_floating_point()))
        return path

    def tree(self):
        def go(t):
            if isinstance(t, dict):
                return {k: go(v) for k, v in t.items()}
            if isinstance(t, tuple):
                return tuple(go(v) for v in t)
            return None if t is None else getattr(self, t)
        return go(self._layout)

    def forward(self, batch):
        """Logits (B, S, V) of ``batch`` (``tokens`` and, for VLMs,
        ``positions``; for Whisper, ``frames``)."""
        return forward(self.tree(), batch, self.cfg)
