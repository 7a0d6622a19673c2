"""Modality frontends — stubs, as in the reference (:mod:`repro.models.frontends`).

The ``[audio]`` / ``[vlm]`` cells specify the transformer backbone only; the
conv/patch frontends are stubbed by precomputed frame/patch inputs.  These
helpers give the stand-in shapes (``*_spec``: tensors on the meta device)
and synthetic inputs (smoke runs).  Random draws take an explicit
``torch.Generator`` where the reference takes a key.
"""
from __future__ import annotations

import torch

from repro_torch.collective.comm import resolve_device

__all__ = ["audio_frames_spec", "audio_frames", "mrope_positions_spec", "mrope_positions"]


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def audio_frames_spec(cfg, batch: int) -> torch.Tensor:
    """Whisper conv-frontend output: (B, F, d) frame embeddings."""
    return torch.empty((batch, cfg.enc_frames, cfg.d_model), dtype=_dtype(cfg), device="meta")


def audio_frames(generator: torch.Generator, cfg, batch: int) -> torch.Tensor:
    """Standard-normal frames on the generator's device, in ``cfg.dtype``."""
    return torch.randn((batch, cfg.enc_frames, cfg.d_model), generator=generator,
                       device=generator.device).to(_dtype(cfg))


def mrope_positions_spec(cfg, batch: int, seq: int) -> torch.Tensor:
    """Qwen2-VL M-RoPE position streams (t/h/w): (3, B, S) int32.

    For text-only spans all three streams are equal; image spans get
    (t, h, w) grid positions from the (stubbed) vision pipeline.
    """
    return torch.empty((3, batch, seq), dtype=torch.int32, device="meta")


def mrope_positions(cfg, batch: int, seq: int, *, image_span: tuple[int, int] | None = None,
                    grid=(16, 16), device=None) -> torch.Tensor:
    """Synthetic M-RoPE positions: text positions with an optional image
    span laid out on an h×w grid (dynamic-resolution stand-in)."""
    device = resolve_device(device)
    t = torch.arange(seq, dtype=torch.int32, device=device)[None].expand(batch, seq)
    pos = torch.stack([t, t, t])
    if image_span is not None:
        s0, s1 = image_span
        _, w = grid
        n = torch.arange(s1 - s0, dtype=torch.int32, device=device)
        pos[0, :, s0:s1] = s0
        pos[1, :, s0:s1] = n // w
        pos[2, :, s0:s1] = n % w
    return pos
