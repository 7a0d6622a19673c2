"""Kernel launch counters.

Each kernel wrapper adds one to its count where it launches its Hopper
kernel, and nowhere else (a CPU tensor takes the plain version and counts
nothing).  A run shows that it went through the kernels by resetting the
counts, driving the path, and reading them::

    dispatch.launches.reset()
    factorize(blocks, QRConfig(local_r="cqr2_pallas"))
    assert dispatch.launches.gram == 1      # one launch for all P ranks
"""
from __future__ import annotations

import dataclasses

__all__ = ["LaunchCounts", "launches"]


@dataclasses.dataclass
class LaunchCounts:
    """One plain integer per kernel wrapper."""

    gram: int = 0
    fused_apply_gram: int = 0
    apply_right: int = 0
    trailing_update: int = 0
    panel_cross: int = 0
    pad_cross: int = 0
    combine_gram: int = 0

    def reset(self) -> None:
        for field in dataclasses.fields(self):
            setattr(self, field.name, 0)

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)


launches = LaunchCounts()
