"""The kernels' execution target: one descriptor, two kinds (the port of
:mod:`repro.kernels.backend`).

  * ``kind`` — ``"cuda"``: the hand-written Hopper kernels (``csrc/``) on
    the card; ``"plain"``: their plain PyTorch versions
    (:mod:`repro_torch.kernels.ref`) on the CPU.  The reference's third
    kind, the Pallas interpreter, has no counterpart: the plain route *is*
    the CPU, so there is no ``interpret`` flag to resolve.
  * ``arch`` — the card's name (``torch.cuda.get_device_name``), or
    ``"cpu"``: the autotune table's key component.
  * ``sublane`` — the row quantum of ``block_rows``: 32, the rows of one
    streamed chunk of every kernel (``_launch._ROWS``, ``cqr2::kRows``).

:func:`pick_block_rows` keeps the reference's clamp: a split is never
taller than ``m`` rounded up to the quantum and never shorter than one
quantum.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import _launch

__all__ = [
    "Backend",
    "DEFAULT_BLOCK_ROWS",
    "KINDS",
    "SUBLANE",
    "backend_of",
    "pick_block_rows",
    "resolve_backend",
]

KINDS = ("cuda", "plain")

SUBLANE = _launch._ROWS

# The reference's untuned panel height, kept as one of the tuner's base
# candidates.  The port's untuned split is not this constant but the
# kernels' own shape-derived one (``_launch.row_split`` / ``cross_split``),
# which the tuner always measures beside the candidates.
DEFAULT_BLOCK_ROWS = 1024


@dataclasses.dataclass(frozen=True)
class Backend:
    """One resolved kernel-execution target (see the module docstring)."""

    kind: str            # "cuda" | "plain"
    arch: str            # the card's name, or "cpu"
    sublane: int         # block_rows quantum
    device: torch.device

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")


@functools.lru_cache(maxsize=None)
def backend_of(device: torch.device) -> Backend:
    """The backend of tensors on ``device`` (already resolved; cached, as
    the wrappers ask per call)."""
    device = torch.device(device)
    if device.type == "cuda":
        return Backend("cuda", torch.cuda.get_device_name(device), SUBLANE, device)
    if device.type == "cpu":
        return Backend("plain", "cpu", SUBLANE, device)
    raise ValueError(f"tensors on {device} are not supported; use cuda or cpu")


def resolve_backend(device=None) -> Backend:
    """``None`` means the card and raises without one; ``"cpu"`` is the
    plain route."""
    from repro_torch.collective.comm import resolve_device

    return backend_of(resolve_device(device))


def _ceil_to(x: int, q: int) -> int:
    return -(-x // q) * q


def pick_block_rows(m: int, block_rows: int, *, sublane: int = SUBLANE) -> int:
    """Clamp a row split to the quantum: never taller than ``m`` rounded up
    to ``sublane``, never shorter than one ``sublane``."""
    return max(sublane, min(int(block_rows), _ceil_to(int(m), sublane)))
