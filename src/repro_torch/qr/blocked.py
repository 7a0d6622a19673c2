"""Fault-tolerant right-looking blocked QR for general m×n matrices.

TSQR is the *panel* factorization inside a right-looking blocked QR, and the
butterfly's ``2^s``-copy redundancy protects every panel's reduced factors
(Coti, "Fault Tolerant QR Factorization for General Matrices").  Per column
panel ``k`` of width ``b``:

  1. **Panel reduction** — each rank's local R of the panel (by default the
     Cholesky of the lookahead Gram, ``local_r="chol"``) rides the
     fault-tolerant butterfly; every valid rank ends with the same ``R_kk``.
  2. **Explicit panel Q** — ``Q_k = A_panel R_kk⁻¹`` locally, plus
     ``reorth`` CholeskyQR polish passes over the same butterfly.
  3. **Block row of R** — ``W = R_totᵀ⁻¹ Σ_ranks A_panelᵀ A_trail``.  The
     cross products ride the *same* butterfly as the panel R by default
     (``fuse="auto"``: one stacked payload, ``log P`` rounds per panel);
     ``fuse="off"`` runs a second ``sum`` butterfly after Q.
  4. **Trailing update** — ``A_trail ← A_trail − Q_k W`` by the
     ``trailing_update`` kernel, which also accumulates the *next* panel's
     Gram and cross products in the same sweep, so K panels cost K
     trailing-block sweeps (a ``panel_cross`` prime plus K − 1 updates).

A death during phase 1 or 3 follows the variant's butterfly guarantee.
Ranks that lose a replicated factor are restored at the phase boundary by a
replica fetch (``recover="replica"``); with ``recover="off"`` the poisoned
ranks stay NaN and rot every later panel.  ``valid`` reports the strict
survivors; ``reports`` the per-panel tolerance verdicts and recovery counts.

Two drivers, equal bit for bit on fault-free plans:

  * the eager per-panel driver (:func:`_blocked_body`) sweeps the live,
    shrinking trailing block and handles every fault schedule;
  * the fixed-shape pipeline (:func:`_pipeline_body`) keeps the working
    matrix at the padded width ``n_pad = K·b`` in a shifted layout (the live
    panel is always columns ``[0, b)``), primed by ``pad_cross`` when
    ``n < n_pad``.  Every panel has the same shapes, so the whole
    factorization is one cached program (:mod:`repro_torch.replay`): one
    CUDA graph per (plan, widths, canonical config, shape, dtype, device),
    captured at the first call and replayed on every later one, which
    counts one ``blocked_qr_pipeline`` dispatch.  The trailing update writes
    A_new into the leading columns of a second buffer whose last ``b``
    columns are zero, so the shift left costs no copy.  Fault-free runs
    take it under ``pipeline="auto"``; the 4-D batched route always does.

With ``redundancy="coded"`` every panel reduction is a checksum-coded one
over the P data ranks plus ``parity`` checksum ranks (a per-panel
:class:`~repro_torch.collective.coded.CodedPlan` for R and for W): erased
contributions are reconstructed inside the collective, every data rank
receives the result, and ``detected`` ORs the panels' verification flags.
Coded runs always take the eager driver; the sweeps stay at P blocks and
only the reductions run over the ``P + parity`` world.

The reference's ``lax.scan`` becomes a Python loop over the same fixed
shapes, captured whole; the eager driver and every faulted or coded call
stay eager, as in the reference.

Under ``mesh=`` each rank is a process holding its own (m_local, n) rows
(:class:`~repro_torch.collective.comm.DistComm`): the same two drivers run
on the local block, the butterflies and the replica fetches cross
processes, and each driver is one cached per-rank program
(:mod:`repro_torch.qr._shard`), run eagerly.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch import replay
from repro_torch.collective._tree import tree_map
from repro_torch.collective.coded import CodedPlan, execute_coded, make_coded_plan
from repro_torch.collective.comm import Comm, DistComm, SimComm
from repro_torch.collective.engine import ft_allreduce, recover_payload
from repro_torch.collective.faults import FaultSpec, within_tolerance
from repro_torch.collective.plan import Plan, make_plan
from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels import dispatch as _dispatch
from repro_torch.kernels import ops as kops
from repro_torch.kernels import traffic as _traffic
from repro_torch.kernels.backend import backend_of

from ._shard import dummy_q
from .api import (
    Fuse,
    Pipeline,
    QRConfig,
    Recover,
    Redundancy,
    _as_tensor,
    _mesh_block,
    resolve_device,
    warn_deprecated_entry,
)
from .panel import FUSED_PANEL_COMBINER, PanelFactorizer, chol_r

__all__ = ["PIPELINE_NAME", "BlockedQRResult", "PanelFaultSchedule", "PanelReport",
           "blocked_qr_batched", "blocked_qr_shard_map", "blocked_qr_sim", "panel_widths"]

PIPELINE_NAME = "blocked_qr_pipeline"    # trace/dispatch counter key


def panel_widths(n: int, panel_width: int) -> tuple[int, ...]:
    """Column widths of the ``⌈n / panel_width⌉`` panels (ragged tail)."""
    if panel_width <= 0:
        raise ValueError(f"panel_width must be positive, got {panel_width}")
    k = math.ceil(n / panel_width)
    return tuple(min(panel_width, n - i * panel_width) for i in range(k))


@dataclasses.dataclass(frozen=True)
class PanelFaultSchedule:
    """Fail-stop deaths scheduled into a blocked factorization.

    ``panel[k]`` strikes during panel ``k``'s R reduction (phase 1);
    ``update[k]`` during its cross-product reduction (phase 3, the
    observable "death during the trailing update").  Each value is a
    :class:`~repro_torch.collective.faults.FaultSpec` whose steps index
    that butterfly's exchanges.
    """

    panel: Mapping[int, FaultSpec] = dataclasses.field(default_factory=dict)
    update: Mapping[int, FaultSpec] = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, panel=None, update=None) -> "PanelFaultSchedule":
        """From ``{panel_index: FaultSpec | {rank: step}}`` mappings."""

        def norm(d):
            return {
                int(k): v if isinstance(v, FaultSpec) else FaultSpec.of(v)
                for k, v in (d or {}).items()
            }

        return cls(panel=norm(panel), update=norm(update))

    def __bool__(self) -> bool:
        return bool(self.panel) or bool(self.update)


@dataclasses.dataclass(frozen=True)
class PanelReport:
    """Host-side verdicts for one panel.

    ``fused`` — the panel's R and cross-product leaves ship as one stacked
    payload over ``plan_r``, issued as soon as the producing sweep lands its
    lookahead accumulators and consumed one stage later.  A panel with an
    update-phase fault cannot fuse: the death indexes the second
    butterfly's exchanges.

    ``scheme`` — ``"butterfly"``: ``recovered_*`` counts ranks that fetch
    full replicas at the phase boundary; ``"coded"``: it counts the erased
    contributions reconstructed from parity inside the collective.
    """

    panel: int
    plan_r: Plan | CodedPlan
    plan_w: Plan | CodedPlan | None
    within_tolerance_r: bool
    within_tolerance_w: bool
    recovered_r: int          # contributions restored after phase 1
    recovered_w: int          # …after phase 3
    recoverable: bool         # some rank held every replicated factor
    fused: bool = False
    scheme: str = "butterfly"

    @property
    def within_tolerance(self) -> bool:
        return self.within_tolerance_r and self.within_tolerance_w


@dataclasses.dataclass
class BlockedQRResult:
    """Outcome of a fault-tolerant blocked QR.

    ``r``       — (P, n, n), (B, P, n, n) for a batch, or under ``mesh=``
                  this rank's (1, n, n): the assembled upper-triangular
                  factor on every rank.
    ``valid``   — (P,), (B, P) or this rank's (1,): strict survivors, valid
                  through every panel's reductions without replica recovery.
    ``q``       — optional per-rank (m_local, n) orthonormal factor.
    ``reports`` — per-panel :class:`PanelReport`.
    ``detected``— coded runs only: (P,) device bool, OR over all panels,
                  flagging ranks whose payload failed checksum verification.
    """

    r: torch.Tensor
    valid: torch.Tensor
    q: torch.Tensor | None
    reports: tuple[PanelReport, ...]
    panel_width: int
    detected: torch.Tensor | None = None

    @property
    def n_panels(self) -> int:
        return len(self.reports)

    @property
    def recoverable(self) -> bool:
        return all(rep.recoverable for rep in self.reports)


def _data_valid(plan) -> np.ndarray:
    """The data ranks' slice of ``final_valid`` (a coded plan appends its
    parity ranks, which the driver's validity logic must not see)."""
    return plan.final_valid[: getattr(plan, "n_data", plan.n_ranks)]


# ---------------------------------------------------------------------------
# Host-side planning
# ---------------------------------------------------------------------------

def _build_reports(variant: str, p: int, widths: tuple[int, ...],
                   faults: PanelFaultSchedule, recover: Recover, fuse: Fuse,
                   redundancy: Redundancy = Redundancy.BUTTERFLY,
                   parity: int = 2) -> tuple[PanelReport, ...]:
    n_panels = len(widths)
    coded = redundancy is Redundancy.CODED
    for key in set(faults.panel) | set(faults.update):
        if not 0 <= key < n_panels:
            raise ValueError(
                f"fault schedule names panel {key}, but only {n_panels} panels exist"
            )
    if (n_panels - 1) in faults.update:
        raise ValueError(
            f"panel {n_panels - 1} is the last panel — it has no trailing "
            "update to die during"
        )
    reports = []
    for k in range(n_panels):
        spec_r = faults.panel.get(k, FaultSpec.none())
        spec_w = None if k == n_panels - 1 else faults.update.get(k, FaultSpec.none())
        # fuse unless the schedule pins a death to the second butterfly
        fused = fuse is not Fuse.OFF and k not in faults.update
        if coded:
            # a per-panel coded plan over P + parity ranks: within tolerance
            # is the erasure budget, and recovered_* counts the
            # contributions reconstructed in-collective
            plan_r = make_coded_plan(p, parity, spec_r)
            plan_w = None if spec_w is None else make_coded_plan(p, parity, spec_w)
            tol_r = plan_r.recoverable
            tol_w = plan_w is None or plan_w.recoverable
            recoverable = tol_r and tol_w
            rec_r = plan_r.n_erased if tol_r else 0
            rec_w = plan_w.n_erased if plan_w is not None and tol_w else 0
        else:
            plan_r = make_plan(variant, p, spec_r)
            plan_w = None if spec_w is None else make_plan(variant, p, spec_w)
            tol_r = within_tolerance(variant, spec_r, plan_r.n_steps)
            tol_w = plan_w is None or within_tolerance(variant, spec_w, plan_w.n_steps)
            recoverable = bool(plan_r.final_valid.any()) and (
                plan_w is None or bool(plan_w.final_valid.any())
            )
            # recovered_* counts the ranks a replica fetch restores (zero
            # when recovery is off: the ranks stay poisoned)
            fetching = recover is Recover.REPLICA and recoverable
            rec_r = int((~plan_r.final_valid).sum()) if fetching else 0
            rec_w = int((~plan_w.final_valid).sum()) if fetching and plan_w is not None else 0
        if fused and plan_w is not None:
            rec_w = rec_r          # one stacked reduction restores both leaves
        reports.append(PanelReport(
            panel=k, plan_r=plan_r, plan_w=plan_w, within_tolerance_r=tol_r,
            within_tolerance_w=tol_w, recovered_r=rec_r, recovered_w=rec_w,
            recoverable=recoverable, fused=fused, scheme="coded" if coded else "butterfly",
        ))
    if fuse is Fuse.ON:
        bad = [r.panel for r in reports if not r.fused]
        if bad:
            raise ValueError(
                f"fuse=Fuse.ON but panels {bad} carry update-phase faults, "
                "which require the split two-butterfly schedule; schedule "
                "the death on the panel phase or use Fuse.AUTO"
            )
    return tuple(reports)


# ---------------------------------------------------------------------------
# Shared pieces of both drivers
# ---------------------------------------------------------------------------

def _solve_w(r_tot, c_sum, pad_to: int | None = None):
    """W = R_totᵀ⁻¹ C  (C = Σ A_panelᵀ A_trail, so W = Q_kᵀ A_trail).

    ``pad_to`` right-pads the right-hand side with zero columns before the
    solve and slices the result back: both drivers solve every panel at the
    padded width ``n_pad − b``, so a batched triangular solve whose
    per-column results depend on the width still gives both the same bits.
    """
    nt = c_sum.shape[-1]
    if pad_to is not None and pad_to > nt:
        c_sum = torch.nn.functional.pad(c_sum, (0, pad_to - nt))
    w = torch.linalg.solve_triangular(r_tot.mT, c_sum, upper=False)
    return w[..., :nt] if pad_to is not None and pad_to > nt else w


def _local_r(pf: PanelFactorizer, local_r: str, panel, g):
    """The panel's local R: the Cholesky of the lookahead Gram (``"chol"``,
    no panel read) or the factorizer's local QR of the panel."""
    if local_r == "chol":
        return chol_r(g)
    return pf.local_fn()(panel.to(torch.float32).contiguous())


def _form_q(pf: PanelFactorizer, panel, r_red, comm: Comm, dtype):
    q_k, r_tot = pf.form_q(panel.to(torch.float32), r_red, comm)
    return q_k.to(dtype).contiguous(), r_tot


def _assemble(rows, r_last, n: int, b: int, like):
    """R in original column coordinates from the per-panel (…, b, ≥ n − c0)
    block rows and the last panel's triangle."""
    r_full = torch.zeros(like.shape[:-2] + (n, n), dtype=torch.float32, device=like.device)
    for k, row in enumerate(rows):
        c0 = k * b
        r_full[..., c0:c0 + b, c0:] = row[..., :, :n - c0]
    c0 = len(rows) * b
    r_full[..., c0:, c0:] = r_last
    return r_full


# ---------------------------------------------------------------------------
# The eager per-panel driver (every fault schedule)
# ---------------------------------------------------------------------------

def _blocked_body(a, comm: Comm, reports: tuple[PanelReport, ...], widths: tuple[int, ...],
                  pf: PanelFactorizer, *, local_r: str, compute_q: bool, use_pallas: bool,
                  world: Comm | None = None, block_rows: int | None = None):
    """The eager driver.  ``world`` (the P + parity ranks) makes every
    reduction a coded one; the sweeps, Q and the polish stay on ``comm``.
    Every sweep takes ``block_rows`` (the config's, resolved by
    :func:`_tuned_config`); ``None`` pins the kernels' untuned split
    (``"auto"``) rather than a per-call lookup, so each sweep sums the rows
    the pipeline's would, whatever table is installed."""
    br = "auto" if block_rows is None else block_rows
    n = a.shape[-1]
    n_pad = widths[0] * len(widths)
    r_full = torch.zeros(a.shape[:-2] + (n, n), dtype=torch.float32, device=a.device)
    valid = comm.take(np.ones(comm.n_ranks, dtype=bool))
    coded = world is not None
    detected = torch.zeros_like(valid) if coded else None
    q_cols = []
    trail = a
    s = kops.panel_cross(a, split=widths[0], use_pallas=use_pallas, block_rows=br)  # prime

    def coded_reduce(payload, plan, combiner):
        p = comm.n_ranks
        val, fv, det = execute_coded(payload, world, plan, combiner)
        return tree_map(lambda t: t[:p], val), fv[:p], det[:p]

    def reduce_r(r_loc, plan):
        if coded:
            return coded_reduce(r_loc, plan, FUSED_PANEL_COMBINER.parts[0])
        return (*pf.reduce_r_prepared(r_loc, comm, plan), None)

    def issue(rep, panel, g_loc, c_loc):
        """Put a fused panel's single butterfly on the wire: the stacked
        (R, Σ AᵖᵀAᵗ) payload over ``plan_r`` (R only for the last panel),
        right after the sweep that produced the lookahead accumulators."""
        r_loc = _local_r(pf, local_r, panel, g_loc)
        if rep.plan_w is None:
            r_kk, valid_r, det = reduce_r(r_loc, rep.plan_r)
            return r_kk, None, valid_r, det
        if coded:
            (r_kk, c_sum), v, det = coded_reduce((r_loc, c_loc), rep.plan_r,
                                                 FUSED_PANEL_COMBINER)
            return r_kk, c_sum, v, det
        (r_kk, c_sum), v = pf.reduce_panel_fused(r_loc, c_loc, comm, rep.plan_r)
        return r_kk, c_sum, v, None

    pending = None
    if reports[0].fused:
        b0 = widths[0]
        pending = issue(reports[0], trail[..., :, :b0], s[..., :, :b0], s[..., :, b0:])
    c0 = 0
    for rep, b in zip(reports, widths):
        nt = n - c0 - b
        panel = trail[..., :, :b]
        # -- phase 1: panel reduction(s) over the butterfly -----------------
        if rep.fused:
            r_kk, c_sum, valid_r, det = pending
            pending = None
        else:
            r_loc = _local_r(pf, local_r, panel, s[..., :, :b])
            r_kk, valid_r, det = reduce_r(r_loc, rep.plan_r)
            c_sum = None
        valid = valid & valid_r
        if det is not None:
            detected = detected | det
        if rep.recovered_r:
            # a coded plan reconstructed in-collective: this only checks
            # that the erasure budget held
            if c_sum is not None:
                # one fetch restores both stacked leaves
                r_kk, c_sum = recover_payload(
                    (r_kk, c_sum), comm, rep.plan_r.final_valid, plan=rep.plan_r)
            else:
                r_kk = recover_payload(r_kk, comm, rep.plan_r.final_valid, plan=rep.plan_r)
        # -- phase 2: explicit panel Q (+ polish) ---------------------------
        # The polish's Gram all-reduce mixes every rank's contribution, so a
        # no-recovery run that left poisoned ranks skips it: survivors keep
        # their exact unpolished factor instead of inheriting the NaN.
        clean = bool(_data_valid(rep.plan_r).all()) or bool(rep.recovered_r)
        pf_k = pf if clean else dataclasses.replace(pf, reorth=0)
        q_k, r_tot = _form_q(pf_k, panel, r_kk, comm, a.dtype)
        if compute_q:
            q_cols.append(q_k)
        if not nt:
            r_full[..., c0:c0 + b, c0:] = r_tot
            break
        # -- phase 3: block row of R ----------------------------------------
        if not rep.fused:
            # split schedule: a second, serialized sum butterfly over its own
            # plan (update-phase deaths strike here)
            if coded:
                c_sum, valid_w, det_w = coded_reduce(s[..., :, b:], rep.plan_w,
                                                     FUSED_PANEL_COMBINER.parts[1])
                detected = detected | det_w
            else:
                c_sum, valid_w = ft_allreduce(s[..., :, b:], comm, op="sum", plan=rep.plan_w)
            valid = valid & valid_w
            if rep.recovered_w:
                c_sum = recover_payload(c_sum, comm, rep.plan_w.final_valid, plan=rep.plan_w)
        w = _solve_w(r_tot, c_sum, pad_to=n_pad - widths[0])
        r_full[..., c0:c0 + b, c0:] = torch.cat([r_tot, w], dim=-1)
        # -- phase 4: one-sweep trailing update + lookahead -----------------
        b2 = widths[rep.panel + 1]
        trail, s = kops.trailing_update(trail[..., :, b:], q_k, w.to(a.dtype).contiguous(),
                                        next_width=b2, use_pallas=use_pallas, block_rows=br)
        nxt = reports[rep.panel + 1]
        if nxt.fused:
            # the next panel's butterfly goes out as soon as the sweep lands
            pending = issue(nxt, trail[..., :, :b2], s[..., :, :b2], s[..., :, b2:])
        c0 += b
    q = torch.cat(q_cols, dim=-1) if compute_q else None
    return r_full, valid, q, detected


# ---------------------------------------------------------------------------
# The fixed-shape pipeline (fault-free hot path)
# ---------------------------------------------------------------------------

def _plans_fault_free(reports: tuple[PanelReport, ...]) -> bool:
    """Pipeline eligibility: every collective rides the straight-line fast
    path (also excludes ``tree``, whose fault-free plans leave non-root ranks
    invalid)."""
    return all(
        rep.plan_r.is_fault_free and (rep.plan_w is None or rep.plan_w.is_fault_free)
        for rep in reports
    )


def _resolve_pipeline(pipeline: Pipeline, reports) -> bool:
    """True → the fixed-shape pipeline, False → the eager driver."""
    fault_free = _plans_fault_free(reports)
    if pipeline is Pipeline.ON and not fault_free:
        raise ValueError(
            "pipeline=Pipeline.ON requires fault-free plans (the fixed-shape "
            "pipeline has no validity machinery); faulty plans route to the "
            "general driver under Pipeline.AUTO"
        )
    return fault_free and pipeline is not Pipeline.OFF


class _ShiftedWork:
    """The pipeline's working matrix at the padded width ``n_pad``.

    :meth:`update` runs one trailing sweep on columns ``[b, n_pad)`` and
    writes A_new into columns ``[0, n_pad − b)`` of a second buffer whose
    last ``b`` columns are zero, so the new matrix is the old one shifted
    left by ``b`` with fresh zero columns, without a copy.  The buffer read
    becomes the next one written (its last ``b`` columns zeroed) unless it
    is the caller's input.
    """

    def __init__(self, awork, b: int, use_pallas: bool, owned: bool, block_rows: int | None):
        self.awork, self.b, self.use_pallas = awork, b, use_pallas
        self.block_rows = block_rows
        self.owned = owned
        self.spare = None

    def update(self, q_k, w):
        awork, b = self.awork, self.b
        n_pad = awork.shape[-1]
        out = self.spare
        if out is None:
            out = torch.empty_like(awork)
            out[..., :, n_pad - b:].zero_()
        _, s_new = kops._trailing_update_raw(
            awork[..., :, b:], q_k, w.to(awork.dtype).contiguous(), next_width=b,
            use_pallas=self.use_pallas, out=out[..., :, :n_pad - b], block_rows=self.block_rows)
        if self.owned:
            awork[..., :, n_pad - b:].zero_()
            self.spare = awork
        self.awork, self.owned = out, True
        return out, torch.cat([s_new, s_new.new_zeros(s_new.shape[:-1] + (b,))], dim=-1)


def _prime(a, b: int, n_pad: int, use_pallas: bool, block_rows: int | None):
    """Padded working copy (only when ``n < n_pad``) and panel 0's lookahead,
    in one sweep.  Returns ``(awork, s, owned)``."""
    kw = dict(use_pallas=use_pallas, block_rows=block_rows)
    if n_pad == a.shape[-1]:
        return a, kops._panel_cross_raw(a, split=b, **kw), False
    awork, s = kops._pad_cross_raw(a, split=b, out_width=n_pad, **kw)
    return awork, s, True


def _pipeline_body(a, comm: Comm, plan: Plan, widths: tuple[int, ...], pf: PanelFactorizer, *,
                   local_r: str, compute_q: bool, use_pallas: bool, fused: bool = True,
                   block_rows: int | None = None):
    """The fixed-shape driver (``plan`` is the one fault-free plan every
    collective shares).  ``fused`` runs the one-butterfly-per-panel schedule
    with each reduction issued one stage ahead; otherwise the split
    two-butterfly schedule.  Both equal the eager driver bit for bit."""
    b, k_panels, b_last = widths[0], len(widths), widths[-1]
    n = a.shape[-1]
    awork, s, owned = _prime(a, b, b * k_panels, use_pallas, block_rows)
    work = _ShiftedWork(awork, b, use_pallas, owned, block_rows)
    rows, qs = [], []
    if not fused:
        for _ in range(k_panels - 1):
            awork = work.awork
            r_loc = _local_r(pf, local_r, awork[..., :, :b], s[..., :, :b])
            r_kk, _ = pf.reduce_r_prepared(r_loc, comm, plan)
            q_k, r_tot = _form_q(pf, awork[..., :, :b], r_kk, comm, a.dtype)
            c_sum, _ = ft_allreduce(s[..., :, b:], comm, op="sum", plan=plan)
            w = _solve_w(r_tot, c_sum)
            _, s = work.update(q_k, w)
            rows.append(torch.cat([r_tot, w], dim=-1))
            qs.append(q_k)
        panel = work.awork[..., :, :b_last]
        r_loc = _local_r(pf, local_r, panel, s[..., :b_last, :b_last])
        r_red, _ = pf.reduce_r_prepared(r_loc, comm, plan)
    else:
        def issue(awork, s):
            r_loc = _local_r(pf, local_r, awork[..., :, :b], s[..., :, :b])
            (r_red, c_red), _ = pf.reduce_panel_fused(r_loc, s[..., :, b:], comm, plan)
            return r_red, c_red

        def issue_last(panel, g):
            # the last panel has no cross leaf; reduce at the exact ragged
            # width (a width-b Gram of a ragged panel is singular)
            r_red, _ = pf.reduce_r_prepared(_local_r(pf, local_r, panel, g), comm, plan)
            return r_red

        if k_panels == 1:
            r_red = issue_last(awork[..., :, :b_last], s[..., :b_last, :b_last])
        else:
            r_red, c_red = issue(awork, s)
            for k in range(k_panels - 1):
                q_k, r_tot = _form_q(pf, work.awork[..., :, :b], r_red, comm, a.dtype)
                w = _solve_w(r_tot, c_red)
                awork, s = work.update(q_k, w)
                if k < k_panels - 2:
                    r_red, c_red = issue(awork, s)
                else:
                    r_red = issue_last(awork[..., :, :b_last], s[..., :b_last, :b_last])
                rows.append(torch.cat([r_tot, w], dim=-1))
                qs.append(q_k)
        panel = work.awork[..., :, :b_last]
    q_last, r_last = _form_q(pf, panel, r_red, comm, a.dtype)
    r_full = _assemble(rows, r_last, n, b, a)
    q = torch.cat(qs + [q_last], dim=-1) if compute_q else None
    return r_full, comm.take(np.ones(comm.n_ranks, dtype=bool)), q


# ---------------------------------------------------------------------------
# Accounting: the reference's records for the same call
# ---------------------------------------------------------------------------

def _note_reductions(name: str, reports, widths, c_widths, reorth_counts,
                     reorth_plan: Plan, wire_scale: int = 1) -> None:
    """One ``panel_reduce`` record per butterfly (a fused panel is one
    record carrying the stacked payload, a split panel two) plus a
    ``reorth_reduce`` record for the polish passes: serial rounds,
    plan-priced wire bytes and the overlap flag.  ``c_widths`` is the cross
    width each panel reduces (padded in the pipeline, live in the eager
    driver), ``reorth_counts`` the polish passes each panel ran and
    ``wire_scale`` the batch factor.  The rounds and overlaps also go to
    the entry point ``name``'s dispatch records."""
    for rep, b, cw, n_reorth in zip(reports, widths, c_widths, reorth_counts):
        overlapped = 1 if rep.fused and rep.panel > 0 else 0
        if rep.fused or rep.plan_w is None:
            leaves = [(b, b, 4, False)]
            if rep.plan_w is not None:
                leaves.append((b, cw, 4, False))
            recs = [(rep.plan_r, leaves, overlapped)]
        else:
            recs = [(rep.plan_r, [(b, b, 4, False)], 0), (rep.plan_w, [(b, cw, 4, False)], 0)]
        for plan, leaves, ov in recs:
            rounds = plan.round_count()
            _traffic.note("panel_reduce", dispatches=0, rounds=rounds,
                          wire_bytes=wire_scale * plan.bytes_on_wire_stacked(leaves),
                          overlapped=ov)
            _dispatch.note_rounds(name, rounds)
            if ov:
                _dispatch.note_overlap(name, ov)
        if n_reorth:
            rounds = n_reorth * reorth_plan.round_count()
            _traffic.note(
                "reorth_reduce", dispatches=0, rounds=rounds,
                wire_bytes=wire_scale * n_reorth
                * reorth_plan.bytes_on_wire_stacked([(b, b, 4, True)]),
            )
            _dispatch.note_rounds(name, rounds)


def _note_eager_reductions(name: str, reports, widths, n: int, pf: PanelFactorizer) -> None:
    """Collective records of one eager factorization: cross leaves at their
    live widths, no polish on panels a no-recovery fault left unclean."""
    c_widths, c0 = [], 0
    for b in widths:
        c_widths.append(n - c0 - b)
        c0 += b
    reorth_counts = tuple(
        pf.reorth if bool(_data_valid(rep.plan_r).all()) or rep.recovered_r else 0
        for rep in reports
    )
    plan0 = reports[0].plan_r
    _note_reductions(name, reports, widths, tuple(c_widths), reorth_counts,
                     make_plan("redundant", getattr(plan0, "n_data", plan0.n_ranks)))


def _note_pipeline(shape, dtype, widths, traced: int, reports, reorth: int) -> None:
    """Per-call records of the fixed-shape pipeline, equal to the
    reference's: one ``PIPELINE_NAME`` dispatch; the prime and K − 1
    trailing sweeps at the padded width (only the trailing path; a ``cqr2``
    local QR's narrow sweeps are not recorded), the first carrying the
    call's one dispatch and its ``traced`` new programs; then the collective
    records."""
    _dispatch.note_dispatch(PIPELINE_NAME)
    lead = math.prod(shape[:-2])
    m, n = shape[-2], shape[-1]
    b, k_panels = widths[0], len(widths)
    n_pad = b * k_panels
    it = torch.empty((), dtype=dtype).element_size()
    if n_pad == n:
        recs = [("panel_cross", lead * m * n * it, lead * b * n * 4)]
    else:
        recs = [("pad_cross", lead * m * n * it, lead * (m * n_pad * it + b * n_pad * 4))]
    nt = n_pad - b
    recs += [("trailing_update", lead * (m * nt * it + m * b * it + b * nt * it),
              lead * (m * nt * it + b * nt * 4))] * (k_panels - 1)
    for i, (op, read, write) in enumerate(recs):
        _traffic.note(op, sweeps=1, read_bytes=read, write_bytes=write,
                      dispatches=int(i == 0), traces=traced if i == 0 else 0)
    c_widths = tuple(n_pad - b if k < k_panels - 1 else 0 for k in range(k_panels))
    _note_reductions(PIPELINE_NAME, reports, widths, c_widths, (reorth,) * k_panels,
                     make_plan("redundant", reports[0].plan_r.n_ranks),
                     wire_scale=math.prod(shape[:-3]))


# ---------------------------------------------------------------------------
# Entries (routed to by repro_torch.qr.api.factorize)
# ---------------------------------------------------------------------------

def _setup(m_local: int, n: int, p: int, config: QRConfig, faults: PanelFaultSchedule | None):
    """Geometry validation and host planning; policy validation already
    happened in ``QRConfig``."""
    widths = panel_widths(n, config.panel_width)
    if m_local < max(widths):
        raise ValueError(
            f"each rank's row block ({m_local} rows) must be at least as "
            f"tall as the widest panel ({max(widths)}); shrink panel_width "
            "or use fewer ranks"
        )
    reports = _build_reports(config.variant, p, widths, faults or PanelFaultSchedule(),
                             config.recover, config.fuse, config.redundancy, config.parity)
    return widths, reports, config.factorizer()


def _note_sweep_traces(mn, dtype, widths, canon: QRConfig, lead: tuple) -> None:
    """The reference's ``kernel:<op>`` traces of the pipeline's sweeps: its
    scan traces the prime and the trailing sweep once, however many panels
    run, with the config's ``block_rows``.  ``lead`` is the leading dims the
    plain route sees: (P,) on simulated ranks (a batched pipeline's matrix
    axis is hidden by its vmap), none in a rank's own body under a mesh."""
    b, k_panels = widths[0], len(widths)
    m, n = mn
    n_pad = b * k_panels

    def like(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    kw = dict(use_pallas=canon.use_pallas, block_rows=canon.block_rows, lead=lead,
              wrapper=False)
    if n_pad == n:
        kops._trace("panel_cross", (like(m, n),), (b,), **kw)
    else:
        kops._trace("pad_cross", (like(m, n),), (b, n_pad), **kw)
    if k_panels > 1:
        kops._trace("trailing_update", (like(m, n_pad - b), like(m, b), like(b, n_pad - b)),
                    (b,), **kw)


def _tuned_config(config: QRConfig, m_local: int, n: int, dtype, device) -> QRConfig:
    """Resolve ``block_rows=None`` to the installed autotune winner for this
    geometry before the config keys a cached program (the reference's
    ``_tuned_config``).  The ``trailing_update`` entry keys the lookup: it
    is the body's dominant sweep and its split is the prime's.  Installing
    a table then re-records only the affected geometries; with no entry
    ``block_rows`` stays None (the kernels' untuned split)."""
    if not config.use_pallas or config.block_rows is not None:
        return config
    br = _autotune.resolve_block_rows("trailing_update", m_local, n, dtype,
                                      backend=backend_of(device))
    return config if br is None else dataclasses.replace(config, block_rows=br)


def _run_pipeline(a, widths, reports, pf: PanelFactorizer, config: QRConfig, *,
                  batched: bool = False):
    """The pipeline as one cached program (one CUDA graph on the card) per
    (P, widths, canonical config, route) and input shape, dtype and device.
    The wrappers' notes are suppressed inside it, where the reference's
    scan traces each kernel once; :func:`_note_pipeline` records the exact
    per-call totals.  ``batched``: ``a`` is (B, P, m_local, n) and the rank
    axis moves to the front inside the program (one copy of the stack, so
    every sweep covers all B·P blocks in one launch)."""
    p = a.shape[-3]
    comm = SimComm(p, a.device)
    plan = make_plan(config.variant, p)
    fused = config.fuse is not Fuse.OFF
    canon = _tuned_config(config, a.shape[-2], a.shape[-1], a.dtype, a.device).canonical()

    def body(a):
        x = a.transpose(0, 1).contiguous() if batched else a
        r, valid, q = _pipeline_body(x, comm, plan, widths, pf, local_r=canon.local_r,
                                     compute_q=canon.compute_q, use_pallas=canon.use_pallas,
                                     fused=fused, block_rows=canon.block_rows)
        if not batched:
            return r, valid, q
        bsz = a.shape[0]
        return (r.transpose(0, 1).contiguous(), valid.expand(bsz, p).clone(),
                None if q is None else q.transpose(0, 1).contiguous())

    _note_sweep_traces(a.shape[-2:], a.dtype, widths, canon, (p,))
    t0 = _dispatch.trace_count(PIPELINE_NAME)
    with _traffic.suppress(), _dispatch.suppress():
        out = replay.run(PIPELINE_NAME, (p, widths, canon, batched), body, (a,))
    _note_pipeline(a.shape, a.dtype, widths, _dispatch.trace_count(PIPELINE_NAME) - t0, reports,
                   config.reorth)
    return out


def _factorize_sim(a_blocks: torch.Tensor, config: QRConfig, *,
                   faults: PanelFaultSchedule | None = None) -> BlockedQRResult:
    """``a_blocks`` is (P, m_local, n) on the target device.  Fault-free
    plans take the fixed-shape pipeline per ``config.pipeline``; faulty
    plans and every coded run the eager driver (the pipeline's one-plan
    butterfly schedule is replica redundancy only)."""
    p, m_local, n = a_blocks.shape
    widths, reports, pf = _setup(m_local, n, p, config, faults)
    comm = SimComm(p, a_blocks.device)
    coded = config.redundancy is Redundancy.CODED
    detected = None
    if not coded and _resolve_pipeline(config.pipeline, reports):
        r, valid, q = _run_pipeline(a_blocks, widths, reports, pf, config)
    else:
        eager_cfg = _tuned_config(config, m_local, n, a_blocks.dtype, a_blocks.device)
        r, valid, q, detected = _blocked_body(
            a_blocks, comm, reports, widths, pf, local_r=config.resolved_local_r(),
            compute_q=config.compute_q, use_pallas=config.use_pallas,
            world=SimComm(p + config.parity, a_blocks.device) if coded else None,
            block_rows=eager_cfg.block_rows if config.use_pallas else None,
        )
        _note_eager_reductions("blocked_qr_sim", reports, widths, n, pf)
    return BlockedQRResult(r=r, valid=valid, q=q, reports=reports,
                           panel_width=config.panel_width, detected=detected)


def _factorize_batched(a_batch: torch.Tensor, config: QRConfig) -> BlockedQRResult:
    """B independent fault-free factorizations of a (B, P, m_local, n) stack
    through the fixed-shape pipeline, one program for the stack.  Returns r
    (B, P, n, n), valid (B, P) and q (B, P, m_local, n)."""
    _, p, m_local, n = a_batch.shape
    widths, reports, pf = _setup(m_local, n, p, config, None)
    if not _plans_fault_free(reports):
        raise ValueError(
            f"variant {config.variant!r} is not pipeline-eligible (its "
            "fault-free plans leave ranks invalid, which the fixed-shape "
            "pipeline has no machinery to track); factor the matrices one "
            "at a time through the 3-D entry instead"
        )
    r, valid, q = _run_pipeline(a_batch, widths, reports, pf, config, batched=True)
    return BlockedQRResult(r=r, valid=valid, q=q, reports=reports,
                           panel_width=config.panel_width)


def _factorize_shard_map(block: torch.Tensor, config: QRConfig, *, mesh, axis: str,
                         faults: PanelFaultSchedule | None = None) -> BlockedQRResult:
    """The production path: ``block`` is this rank's (m_local, n) rows of A,
    row-distributed over ``mesh`` axis ``axis``.

    Fault-free plans take the fixed-shape pipeline (one cached per-rank
    program per (mesh, P, widths, canonical config), counted as the
    ``blocked_qr_pipeline`` trace and dispatch, with the same per-call
    records as the simulated pipeline); faulty plans the eager driver (one
    per (mesh, P, reports, widths, canonical config), counted as
    ``blocked_qr_shard_map``), whose replica fetches cross processes.
    Returns this rank's r (1, n, n), valid (1,) and q (m_local, n) or None.
    """
    p = mesh.shape[axis]
    m_local, n = block.shape
    widths, reports, pf = _setup(m_local, n, p, config, faults)
    config = _tuned_config(config, m_local, n, block.dtype, block.device)
    canon = config.canonical()
    comm = DistComm(p, axis, mesh.group, block.device)
    want_q = config.compute_q
    if _resolve_pipeline(config.pipeline, reports):
        plan = make_plan(config.variant, p)

        def body(a_blk):
            r, valid, q = _pipeline_body(
                a_blk, comm, plan, widths, pf, local_r=canon.local_r, compute_q=want_q,
                use_pallas=canon.use_pallas, fused=canon.fuse is not Fuse.OFF,
                block_rows=canon.block_rows)
            return r[None], valid[None], q if want_q else dummy_q(a_blk)

        _note_sweep_traces((m_local, n), block.dtype, widths, canon, ())
        t0 = _dispatch.trace_count(PIPELINE_NAME)
        with _traffic.suppress(), _dispatch.suppress():
            r, valid, q = replay.run("shard_pipeline", (mesh, axis, p, widths, canon), body,
                                     (block,), trace=PIPELINE_NAME, capture=False)
        _note_pipeline((p, m_local, n), block.dtype, widths,
                       _dispatch.trace_count(PIPELINE_NAME) - t0, reports, pf.reorth)
    else:
        def body(a_blk):
            r, valid, q, _ = _blocked_body(
                a_blk, comm, reports, widths, pf, local_r=canon.local_r, compute_q=want_q,
                use_pallas=canon.use_pallas, block_rows=canon.block_rows)
            return r[None], valid[None], q if want_q else dummy_q(a_blk)

        _dispatch.note_dispatch("blocked_qr_shard_map")
        r, valid, q = replay.run("blocked_qr_shard_map", (mesh, axis, p, reports, widths, canon),
                                 body, (block,), capture=False)
        _note_eager_reductions("blocked_qr_shard_map", reports, widths, n, pf)
    return BlockedQRResult(r=r, valid=valid, q=q if want_q else None, reports=reports,
                           panel_width=config.panel_width)


# ---------------------------------------------------------------------------
# Legacy kwarg entry points (deprecated shims over the implementations)
# ---------------------------------------------------------------------------

def blocked_qr_sim(a_blocks, *, panel_width: int, variant: str = "redundant",
                   faults: PanelFaultSchedule | None = None, compute_q: bool = False,
                   local_r: str = "chol", reorth: int = 1, use_pallas: bool = False,
                   interpret: bool | None = None, recover: str = "replica",
                   pipeline: str = "auto", fuse: str = "auto",
                   device=None) -> BlockedQRResult:
    """Deprecated kwarg shim — build a :class:`~repro_torch.qr.api.QRConfig`
    and call :func:`repro_torch.qr.api.factorize` on the (P, m_local, n) row
    blocks instead.  The kwargs map 1:1 onto config fields (``interpret`` is
    only validated, as the config does); the results are bit for bit the
    same.  ``a_blocks`` is a numpy array or a tensor, moved to ``device``
    (``None``: the card)."""
    warn_deprecated_entry("blocked_qr_sim")
    config = QRConfig(
        panel_width=panel_width, variant=variant, local_r=local_r, reorth=reorth,
        compute_q=compute_q, use_pallas=use_pallas, interpret=interpret,
        pipeline=pipeline, fuse=fuse, recover=recover,
    )
    return _factorize_sim(_as_tensor(a_blocks, resolve_device(device)), config, faults=faults)


def blocked_qr_batched(a_batch, *, panel_width: int, variant: str = "redundant",
                       compute_q: bool = False, local_r: str = "chol", reorth: int = 1,
                       use_pallas: bool = False, interpret: bool | None = None,
                       fuse: str = "auto", device=None) -> BlockedQRResult:
    """Deprecated kwarg shim — build a :class:`~repro_torch.qr.api.QRConfig`
    and call :func:`repro_torch.qr.api.factorize` on the (B, P, m_local, n)
    batch instead (one program either way, the same bits)."""
    warn_deprecated_entry("blocked_qr_batched")
    config = QRConfig(
        panel_width=panel_width, variant=variant, local_r=local_r, reorth=reorth,
        compute_q=compute_q, use_pallas=use_pallas, interpret=interpret, fuse=fuse,
    )
    return _factorize_batched(_as_tensor(a_batch, resolve_device(device)), config)


def blocked_qr_shard_map(a_local, *, mesh, axis: str, panel_width: int,
                         variant: str = "redundant", faults: PanelFaultSchedule | None = None,
                         compute_q: bool = False, local_r: str = "chol", reorth: int = 1,
                         use_pallas: bool = False, interpret: bool | None = None,
                         recover: str = "replica", pipeline: str = "auto",
                         fuse: str = "auto", device=None) -> BlockedQRResult:
    """Deprecated kwarg shim — build a :class:`~repro_torch.qr.api.QRConfig`
    and call :func:`repro_torch.qr.api.factorize` with ``mesh=``/``axis=``
    instead (the same drivers, the same bits).  ``a_local`` is this rank's
    (m_local, n) block, moved to ``device`` (``None``: the mesh's)."""
    warn_deprecated_entry("blocked_qr_shard_map")
    config = QRConfig(
        panel_width=panel_width, variant=variant, local_r=local_r, reorth=reorth,
        compute_q=compute_q, use_pallas=use_pallas, interpret=interpret,
        pipeline=pipeline, fuse=fuse, recover=recover,
    )
    return _factorize_shard_map(_mesh_block(a_local, mesh, device), config, mesh=mesh, axis=axis,
                                faults=faults)
