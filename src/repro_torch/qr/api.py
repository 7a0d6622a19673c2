"""The QR entry facade: one config object, one ``factorize`` call.

:class:`QRConfig` has the reference's fields, enums and validation, so a
config transfers one to one.  :func:`factorize` routes by input rank and
mesh presence:

  ==========================  =====================  ========================
  input                       ``panel_width=None``   ``panel_width`` an int
  ==========================  =====================  ========================
  (P, m_local, n)             TSQR on P ranks        blocked QR on P ranks
  (B, P, m_local, n)          B TSQRs, one launch    B blocked QRs, fixed-shape
                              per kernel             pipeline, one launch per
                                                     sweep
  (m_local, n) + ``mesh=``    TSQR (``gram=True``:   blocked QR, this rank's
                              the Gram butterfly),   rows, one process a rank
                              this rank's rows
  ==========================  =====================  ========================

Without a mesh all P ranks are simulated on one device.  With ``mesh=`` (a
:class:`~repro_torch.collective.dist.RankMesh`) each rank is a process and
passes its own block; the exchanges cross processes
(:class:`~repro_torch.collective.comm.DistComm`).  ``redundancy="coded"``
adds ``parity`` checksum ranks (:mod:`repro_torch.collective.coded`) to the
3-D routes; like the reference, it refuses batches and meshes with
``ValueError``.

Entry points run on the card: ``device=None`` means ``"cuda"`` (under a
mesh, the mesh's device, the card unless its world was started on the CPU)
and raises when there is none; pass ``device="cpu"`` to run on the CPU (the
kernels' plain versions).
"""
from __future__ import annotations

import dataclasses
import enum
import warnings

import numpy as np
import torch

from repro_torch.collective.comm import resolve_device
from repro_torch.collective.faults import FaultSpec
from repro_torch.collective.plan import VARIANTS

__all__ = [
    "Fuse",
    "Pipeline",
    "QRConfig",
    "Recover",
    "Redundancy",
    "factorize",
    "resolve_device",
    "warn_deprecated_entry",
]


class _CoercibleEnum(enum.Enum):
    """Enum with string coercion and an actionable failure mode."""

    @classmethod
    def coerce(cls, value):
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            try:
                return cls(value.lower())
            except ValueError:
                pass
        options = ", ".join(f"{cls.__name__}.{m.name} ({m.value!r})" for m in cls)
        raise ValueError(
            f"{cls.__name__.lower()} must be one of: {options}; "
            f"got {value!r}.  Import the enum from repro_torch.qr.api "
            "(string spellings are accepted case-insensitively)."
        )


class Pipeline(_CoercibleEnum):
    """Blocked driver: compiled pipeline vs eager per-panel driver."""

    AUTO = "auto"
    ON = "on"
    OFF = "off"


class Fuse(_CoercibleEnum):
    """Blocked driver: one stacked butterfly per panel vs two."""

    AUTO = "auto"
    ON = "on"
    OFF = "off"


class Recover(_CoercibleEnum):
    """Blocked driver: replica-fetch restoration of lost ranks."""

    REPLICA = "replica"
    OFF = "off"


class Redundancy(_CoercibleEnum):
    """Which fault-tolerance scheme backs the panel reductions: the paper's
    butterfly replicas, or checksum coding."""

    BUTTERFLY = "butterfly"
    CODED = "coded"


_LOCAL_R = ("auto", "chol", "jnp", "cqr2", "cqr2_pallas")


@dataclasses.dataclass(frozen=True)
class QRConfig:
    """Every static policy knob of a QR factorization, in one frozen value.

    ``panel_width=None`` selects the single-panel TSQR workload.
    ``local_r="auto"`` resolves to ``"jnp"`` (Householder) for TSQR, which
    runs no kernel, and to ``"chol"`` (the Cholesky of the lookahead Gram)
    for the blocked QR; ``"cqr2_pallas"`` runs CholeskyQR2 on the Hopper
    kernels.  ``use_pallas`` puts the blocked QR's trailing sweeps and Q's
    polish Gram on the Hopper kernels; ``pipeline``, ``fuse``, ``recover``
    and ``block_rows`` steer the blocked driver.  ``block_rows`` is the row
    split of its sweeps (a positive multiple of 32 on the kernels, which
    raise otherwise; ``None``: the installed autotune winner for the
    geometry, else the kernels' own split).  The TSQR route reads none of
    those, and its kernels take the installed winners per call, as the
    reference's do; ``interpret`` is only validated, so that configs
    transfer from the reference.
    """

    panel_width: int | None = None
    variant: str = "redundant"
    local_r: str = "auto"
    reorth: int = 1
    compute_q: bool = False
    use_pallas: bool = False
    interpret: bool | None = None
    block_rows: int | None = None
    pipeline: Pipeline = Pipeline.AUTO
    fuse: Fuse = Fuse.AUTO
    recover: Recover = Recover.REPLICA
    gram: bool = False
    redundancy: Redundancy = Redundancy.BUTTERFLY
    parity: int = 2

    def __post_init__(self):
        coerce = object.__setattr__
        coerce(self, "pipeline", Pipeline.coerce(self.pipeline))
        coerce(self, "fuse", Fuse.coerce(self.fuse))
        coerce(self, "recover", Recover.coerce(self.recover))
        coerce(self, "redundancy", Redundancy.coerce(self.redundancy))
        if self.panel_width is not None and self.panel_width <= 0:
            raise ValueError(
                f"panel_width must be a positive int or None (single-panel "
                f"TSQR), got {self.panel_width!r}"
            )
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}; choose from {VARIANTS}")
        if isinstance(self.local_r, str) and self.local_r not in _LOCAL_R:
            raise ValueError(
                f"unknown local_r {self.local_r!r}; choose from {_LOCAL_R} "
                "or pass a callable mapping a panel to its R factor"
            )
        if self.reorth < 0:
            raise ValueError(f"reorth must be >= 0, got {self.reorth}")
        if self.block_rows is not None and self.block_rows <= 0:
            raise ValueError(
                f"block_rows must be a positive int or None, got {self.block_rows!r}"
            )
        if self.gram and self.panel_width is not None:
            raise ValueError(
                "gram=True selects the Gram-butterfly TSQR, which factors "
                "the whole matrix as one panel — it is incompatible with "
                f"panel_width={self.panel_width} (use panel_width=None)"
            )
        if self.panel_width is None and self.local_r == "chol":
            raise ValueError(
                "local_r='chol' derives the panel R from the blocked "
                "driver's lookahead Gram accumulator, which the single-panel "
                "TSQR does not run; use local_r='auto'/'jnp'/'cqr2'/"
                "'cqr2_pallas', or gram=True for the Gram-butterfly TSQR"
            )
        if self.parity < 1:
            raise ValueError(
                f"parity must be >= 1 (the number of checksum ranks the "
                f"coded scheme adds), got {self.parity}"
            )
        if self.redundancy is Redundancy.CODED:
            if self.gram:
                raise ValueError(
                    "redundancy='coded' codes the per-rank R contributions; "
                    "the Gram-butterfly TSQR reduces a Gram matrix over the "
                    "butterfly instead — the two schemes do not compose "
                    "(use gram=False)"
                )
            if self.pipeline is Pipeline.ON:
                raise ValueError(
                    "pipeline='on' demands the compiled butterfly pipeline, "
                    "which is replica-redundancy only; the coded scheme runs "
                    "the eager per-panel driver (use pipeline='auto' or 'off')"
                )

    def resolved_local_r(self) -> str:
        """Concrete local factorization for the selected workload."""
        if self.local_r != "auto":
            return self.local_r
        return "chol" if self.panel_width is not None else "jnp"

    def canonical(self) -> "QRConfig":
        """The program-relevant projection of this config, the key of the
        cached programs (:mod:`repro_torch.replay`): knobs that do not change
        the program (``pipeline`` mode, ``recover`` policy) are normalized
        away and ``local_r="auto"`` is resolved.  Two configs with equal
        ``canonical()`` share one cached program."""
        return dataclasses.replace(
            self,
            local_r=self.resolved_local_r(),
            pipeline=Pipeline.AUTO,
            recover=Recover.REPLICA,
            # block_rows only shapes the kernels' tiling
            block_rows=self.block_rows if self.use_pallas else None,
            # AUTO and ON run the same fused program (ON only tightens the
            # host-side validation); OFF is the split schedule
            fuse=Fuse.OFF if self.fuse is Fuse.OFF else Fuse.AUTO,
            # parity only shapes the program under the coded scheme
            parity=self.parity if self.redundancy is Redundancy.CODED else 2,
        )

    def factorizer(self):
        """The :class:`~repro_torch.qr.panel.PanelFactorizer` this config implies."""
        from .panel import PanelFactorizer

        local_r = self.resolved_local_r()
        return PanelFactorizer(
            local_qr="jnp" if local_r == "chol" else local_r, reorth=self.reorth,
            use_pallas=self.use_pallas and self.panel_width is not None,
        )


def warn_deprecated_entry(name: str) -> None:
    """The ``DeprecationWarning`` of the legacy kwarg entry points
    (``tsqr_sim``, ``blocked_qr_sim``, ``blocked_qr_batched`` and the mesh
    shims ``tsqr_shard_map``, ``tsqr_gram_shard_map``,
    ``blocked_qr_shard_map``)."""
    warnings.warn(
        f"{name}() is deprecated: build a repro_torch.qr.api.QRConfig and call "
        "repro_torch.qr.api.factorize(a, config) instead (same drivers, same "
        "results — the legacy kwargs map 1:1 onto QRConfig fields; see the "
        "migration table in README.md)",
        DeprecationWarning,
        stacklevel=3,
    )


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    elif not isinstance(a, torch.Tensor):
        raise TypeError(f"factorize takes a numpy array or a tensor, got {type(a).__name__}")
    return a.to(device).contiguous()


def _mesh_block(a, mesh, device) -> torch.Tensor:
    """This rank's block on ``device`` (``None``: the mesh's device)."""
    return _as_tensor(a, mesh.device if device is None else resolve_device(device))


def _route_error(a, mesh) -> str:
    return (
        f"cannot route input of shape {getattr(a, 'shape', None)} with "
        f"mesh={'present' if mesh is not None else 'absent'}: factorize "
        "expects (P, m_local, n) row blocks or a batched (B, P, m_local, n) "
        "stack without a mesh, or this rank's (m_local, n) block with mesh= "
        "(and its row-distribution axis=)"
    )


def factorize(a, config: QRConfig | None = None, *, faults=None, device=None,
              mesh=None, axis: str | None = None):
    """Factorize ``a`` (numpy array or tensor) under ``config``.

    3-D input is P row blocks on simulated ranks; 4-D input is a batch of B
    such stacks factored together (fault-free only).  ``panel_width=None``
    runs TSQR, an int the blocked QR.  ``faults`` is a
    :class:`~repro_torch.collective.faults.FaultSpec` for TSQR and a
    :class:`~repro_torch.qr.blocked.PanelFaultSchedule` for the blocked QR.
    Returns :class:`~repro_torch.qr.tsqr.TSQRResult` or
    :class:`~repro_torch.qr.blocked.BlockedQRResult`.

    **Under** ``mesh=`` (a :class:`~repro_torch.collective.dist.RankMesh`;
    ``axis`` defaults to its sole axis) every rank of the mesh calls
    ``factorize`` with the same config and faults.  A process holds only
    its own rows, so the route differs from the reference's in one way:
    ``a`` is **this rank's (m_local, n) block**, not the global (m, n)
    matrix, and the result holds this rank's slice of each of the
    reference's outputs: ``r`` (1, n, n), ``valid`` (1,), ``q``
    (m_local, n) or None, and the reference's ``plan`` or ``reports``.
    Concatenated in rank order over the ranks, these are exactly the
    reference's (P, n, n), (P,) and (m, n).  On a world of one rank the
    local and the global input are the same.  ``gram=True`` selects the
    Gram-butterfly TSQR, a mesh-only route.
    """
    from . import blocked as _blocked
    from . import tsqr as _tsqr

    if config is None:
        config = QRConfig()
    elif not isinstance(config, QRConfig):
        raise TypeError(
            f"config must be a repro_torch.qr.api.QRConfig, got "
            f"{type(config).__name__} — construct one (all fields have "
            "defaults) rather than passing loose kwargs"
        )
    coded = config.redundancy is Redundancy.CODED
    tsqr_mode = config.panel_width is None
    want = FaultSpec if tsqr_mode else _blocked.PanelFaultSchedule
    if faults is not None and not isinstance(faults, want):
        raise TypeError(
            f"faults must be a {want.__name__} for this workload "
            f"(panel_width={config.panel_width}), got {type(faults).__name__}"
        )
    ndim = getattr(a, "ndim", None)
    if mesh is not None:
        if coded:
            raise ValueError(
                "redundancy='coded' is a simulated-ranks scheme: the coded "
                "world holds P data ranks plus `parity` checksum ranks, and "
                "the decode indexes the gather root's row — neither maps "
                "onto the fixed-size shard_map mesh; run the 3-D simulated "
                "entry (or redundancy='butterfly' under the mesh)"
            )
        if ndim != 2:
            raise ValueError(_route_error(a, mesh))
        if axis is None:
            if len(mesh.axis_names) != 1:
                raise ValueError(
                    f"mesh has axes {mesh.axis_names}; pass axis= to pick "
                    "the row-sharding axis"
                )
            axis = mesh.axis_names[0]
        block = _mesh_block(a, mesh, device)
        if tsqr_mode:
            if config.gram:
                return _tsqr._factorize_gram_shard(block, config, mesh=mesh, axis=axis)
            return _tsqr._factorize_shard(block, config, mesh=mesh, axis=axis, fault_spec=faults)
        return _blocked._factorize_shard_map(block, config, mesh=mesh, axis=axis, faults=faults)
    if config.gram:
        raise ValueError(
            "gram=True (the Gram-butterfly TSQR) is a shard_map-only "
            "driver; pass mesh= (and axis=), or use gram=False"
        )
    if ndim not in (3, 4):
        raise ValueError(_route_error(a, mesh))
    if ndim == 4 and coded:
        raise ValueError(
            "batched factorization is the fault-free hot path, where "
            "coded parity buys nothing over the plain butterfly; use "
            "redundancy='butterfly' for batches, or factor matrices "
            "one at a time through the 3-D entry for coded runs"
        )
    if ndim == 4 and faults is not None:
        raise ValueError(
            "batched factorization is the fault-free hot path; factor "
            "faulted matrices one at a time through the 3-D entry instead"
        )
    blocks = _as_tensor(a, resolve_device(device))
    if ndim == 3:
        if tsqr_mode:
            return _tsqr._factorize_sim(blocks, config, fault_spec=faults)
        return _blocked._factorize_sim(blocks, config, faults=faults)
    if tsqr_mode:
        return _tsqr._factorize_batched(blocks, config)
    return _blocked._factorize_batched(blocks, config)
