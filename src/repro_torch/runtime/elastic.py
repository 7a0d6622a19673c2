"""Elastic mesh management: SHRINK / REBUILD at the replica level.

The port of :mod:`repro.runtime.elastic` and of
``repro.compat.mesh_fingerprint``.  On the simulated-replica backend a
mesh is a topology, not a set of devices: a :class:`ReplicaMesh` names its
axes and holds an integer array of replica-slot ids shaped like the
reference's ``mesh.devices``.  ``shrink_mesh`` halves the data axis
(power-of-two widths keep the collective butterfly well-formed) and keeps
the leading slice of the ids; ``rebuild_mesh`` re-instantiates the
original topology once replacement hardware is available (REBUILD).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ReplicaMesh", "mesh_fingerprint", "rebuild_mesh", "shrink_mesh"]


@dataclasses.dataclass(frozen=True, eq=False)
class ReplicaMesh:
    """Axis names and the replica-slot ids, one array axis per name."""

    axis_names: tuple[str, ...]
    ids: np.ndarray

    def __post_init__(self):
        ids = np.array(self.ids, dtype=np.int64)
        ids.setflags(write=False)
        if ids.ndim != len(self.axis_names):
            raise ValueError(f"{ids.ndim}-d ids for axes {self.axis_names}")
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "ids", ids)

    @classmethod
    def of(cls, shape, axis_names=("data", "model")) -> "ReplicaMesh":
        """Slots ``0 .. prod(shape) - 1`` laid out in ``shape`` (the
        reference's ``make_mesh(shape, axis_names)``)."""
        return cls(axis_names, np.arange(int(np.prod(shape))).reshape(shape))

    @property
    def shape(self) -> tuple[int, ...]:
        return self.ids.shape

    def size(self, name: str) -> int:
        return self.ids.shape[self.axis_names.index(name)]


def mesh_fingerprint(mesh: ReplicaMesh) -> tuple:
    """Hashable mesh-equivalence-class key: two meshes over the same slots
    in the same topology fingerprint identically, even when the objects
    are distinct (``rebuild_mesh`` re-instantiates the template)."""
    return mesh.axis_names, mesh.shape, tuple(int(i) for i in mesh.ids.flat)


def shrink_mesh(mesh: ReplicaMesh, drop_replicas: int = 1) -> ReplicaMesh | None:
    """Return a mesh with the data axis halved (dropping ≥ drop_replicas),
    or None if no further shrink is possible."""
    if "data" not in mesh.axis_names:
        return None
    ax = mesh.axis_names.index("data")
    d = mesh.shape[ax]
    new_d = d // 2
    while new_d > 0 and d - new_d < drop_replicas:
        new_d //= 2
    if new_d < 1:
        return None
    take = [slice(None)] * len(mesh.shape)
    take[ax] = slice(0, new_d)
    return ReplicaMesh(mesh.axis_names, mesh.ids[tuple(take)])


def rebuild_mesh(template_mesh: ReplicaMesh) -> ReplicaMesh:
    """REBUILD: re-instantiate the full original topology (replacement
    replicas joined).  The trainer drives this through the ``"rejoin"``
    :class:`~repro_torch.runtime.trainer.FaultEvent`, the inverse of an
    elastic shrink."""
    return ReplicaMesh(template_mesh.axis_names, template_mesh.ids.copy())
