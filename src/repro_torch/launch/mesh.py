"""Production meshes over the rank world: the port of :mod:`repro.launch.mesh`.

Each constructor lays a :class:`~repro_torch.collective.dist.RankMesh` over
the world this process joined (:func:`repro_torch.collective.dist.run_ranks`
or ``init_rank_world``), with the reference's shapes and axis names, through
:func:`~repro_torch.collective.dist.make_rank_mesh`: every rank of the world
calls it in the same order, a rank outside the mesh gets ``None``, and a
world of fewer ranks than the mesh raises the reference's ``ValueError``.

Topology (the reference's): TPU v5e pods of 16 × 16 = 256 chips; the
multi-pod mesh adds a leading "pod" axis.  ``make_tsqr_mesh`` flattens the
ranks into one "rows" axis, the layout the collective butterfly runs on.
"""
from __future__ import annotations

from repro_torch.collective.dist import make_rank_mesh

__all__ = ["make_production_mesh", "make_tsqr_mesh", "make_smoke_mesh"]


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_rank_mesh(shape, axes)


def make_tsqr_mesh(*, multi_pod: bool = False):
    n = 512 if multi_pod else 256
    return make_rank_mesh((n,), ("rows",))


def make_smoke_mesh(data: int = 1, model: int = 1):
    return make_rank_mesh((data, model), ("data", "model"))
