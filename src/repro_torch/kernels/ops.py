"""Public wrappers over the Hopper kernels, the CholeskyQR2 pipeline, the
blocked QR's trailing-block sweeps and the Gram-combine of two R factors.

``cholesky_qr2`` is the local QR of the TSQR variants: two rounds of (Gram
→ n×n Cholesky → triangular inverse → panel product).  The pipeline is
fused: round 1's panel apply also accumulates round 2's Gram
(:func:`fused_apply_gram`), so the full factorization streams the tall
operand 3× and the R-only variant (:func:`cholesky_qr2_r`, what the TSQR
butterfly carries) exactly 2× with no tall intermediate in device memory.
Every wrapper notes one dispatch (:mod:`repro_torch.kernels.dispatch`) and
its traffic (:mod:`repro_torch.kernels.traffic`), as the reference's do, and
the reference's ``kernel:<op>`` trace when its call has a new signature
(:func:`_trace`).

``use_pallas=True`` keeps the reference's spelling and selects the
hand-written Hopper kernels (``csrc/``); ``False`` runs the plain PyTorch
versions (:mod:`repro_torch.kernels.ref`), the counterpart of the
reference's jnp/XLA route.  Every wrapper takes arbitrary leading batch
dims: the (P, m_local, n) stack of all simulated ranks is one launch.

On the kernel route each wrapper resolves its row split per call
(:func:`_resolve_br`, the reference's): an explicit ``block_rows``, else
the installed autotune winner for the shape class
(:mod:`repro_torch.kernels.autotune`; ``fused_apply_gram`` takes
``gram``'s, ``panel_cross`` and ``pad_cross`` take ``trailing_update``'s),
else the kernel's own shape-derived split.

The small-matrix steps stay library calls, as in the reference: the
Cholesky (``torch.linalg.cholesky_ex``) and the triangular inverse
(``torch.linalg.solve_triangular``).
"""
from __future__ import annotations

import torch

from . import autotune as _autotune
from . import dispatch as _dispatch
from . import ref as _ref
from . import traffic as _traffic
from .backend import backend_of
from .apply_right import apply_right as _apply_kernel
from .combine_gram import combine_gram as _combine_kernel
from .fused_apply_gram import fused_apply_gram as _fused_kernel
from .gram import gram as _gram_kernel
from .trailing_update import pad_cross as _pad_cross_kernel
from .trailing_update import panel_cross as _panel_cross_kernel
from .trailing_update import trailing_update as _trailing_kernel

__all__ = [
    "gram",
    "apply_right",
    "fused_apply_gram",
    "cholesky_qr",
    "cholesky_qr2",
    "cholesky_qr2_r",
    "tri_inv",
    "trailing_update",
    "panel_cross",
    "pad_cross",
    "combine_gram",
]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# The reference's plain route of these three runs through module-level
# jits, which trace like the kernels; its plain gram, apply_right,
# fused_apply_gram and combine_gram are jnp and trace nothing.
_PLAIN_TRACED = frozenset({"trailing_update", "panel_cross", "pad_cross"})


def _resolve_br(op: str, m: int, n: int, a: torch.Tensor, block_rows) -> int | None:
    """Resolve the row split at the Python level, per call: explicit >
    installed winner for the shape class > ``None`` (the kernel's own
    split).  ``"auto"`` asks for the kernel's own split whatever is
    installed (the eager blocked driver's untuned sweeps).  The resolved
    int keys the ``kernel:<op>`` trace, so installing a table retraces its
    shape classes only."""
    if block_rows == "auto":
        return None
    return _autotune.resolve_block_rows(op, m, n, a.dtype, explicit=block_rows,
                                        backend=backend_of(a.device))


def _trace(op: str, arrays, statics: tuple = (), *, use_pallas: bool,
           block_rows=None, lead: tuple | None = None, wrapper: bool = True) -> int:
    """Note the reference's ``kernel:<op>`` trace for this call's signature;
    returns the traces noted (0 or 1).

    The reference's kernel is a jit vmapped over the leading dims, so on the
    kernel route the signature is each operand's last two dims and dtype,
    the statics and the ``block_rows`` the kernel is passed: the resolved
    int, or for the untuned split ``"auto"`` from a wrapper (the reference's
    wrapper passes its default height, a function of the shape) and
    ``None`` from a pipeline (``wrapper=False``: the reference's scan
    passes its config's ``block_rows``, ``None`` untuned).  On the
    plain route the reference's jit sees whole operands; ``lead`` replaces
    their leading dims inside a program batched over matrices, whose batch
    axis the reference's vmap hides (the pipeline notes its sweeps so,
    :func:`repro_torch.qr.blocked._note_sweep_traces`)."""
    if use_pallas:
        if block_rows is None and wrapper:
            block_rows = "auto"
        sig = ("kernel", tuple((tuple(t.shape[-2:]), t.dtype) for t in arrays), statics,
               block_rows)
    elif op in _PLAIN_TRACED:
        sig = ("plain", tuple(((tuple(t.shape[:-2]) if lead is None else lead)
                               + tuple(t.shape[-2:]), t.dtype) for t in arrays), statics)
    else:
        return 0
    return _dispatch.note_kernel_trace(op, sig)


def _note(op: str, traces: int, **traffic_kw) -> None:
    """Record one wrapper call: a dispatch and its traffic, with the kernel
    traces the call noted."""
    _dispatch.note_dispatch(op)
    _traffic.note(op, traces=traces, **traffic_kw)


# -- kernel entry points (batched, kernel/plain switchable) ------------------

def gram(a, *, use_pallas: bool = False, block_rows: int | None = None):
    if use_pallas:
        block_rows = _resolve_br("gram", *a.shape[-2:], a, block_rows)
    traced = _trace("gram", (a,), use_pallas=use_pallas, block_rows=block_rows)
    out = _gram_kernel(a, block_rows=block_rows) if use_pallas else _ref.gram(a)
    _note("gram", traced, sweeps=1, read_bytes=_nbytes(a), write_bytes=_nbytes(out))
    return out


def apply_right(a, w, *, use_pallas: bool = False, block_rows: int | None = None):
    if use_pallas:
        block_rows = _resolve_br("apply_right", *a.shape[-2:], a, block_rows)
    traced = _trace("apply_right", (a, w), use_pallas=use_pallas, block_rows=block_rows)
    out = _apply_kernel(a, w, block_rows=block_rows) if use_pallas else _ref.apply_right(a, w)
    _note("apply_right", traced, sweeps=1, read_bytes=_nbytes(a) + _nbytes(w),
          write_bytes=_nbytes(out))
    return out


def fused_apply_gram(a, w, *, use_pallas: bool = False, want_q: bool = True,
                     block_rows: int | None = None):
    """One tall-operand sweep: ``Q = A @ W`` and ``G' = QᵀQ`` together.

    Returns ``(q, g)`` — or just ``g`` when ``want_q=False``, in which case
    the applied panel never reaches device memory.  The split resolves at
    (m, k), the shape of the Q whose Gram it forms, so it is ``gram(q)``'s.
    """
    if use_pallas:
        block_rows = _resolve_br("fused_apply_gram", a.shape[-2], w.shape[-1], a, block_rows)
    traced = _trace("fused_apply_gram", (a, w), (want_q,), use_pallas=use_pallas,
                    block_rows=block_rows)
    if use_pallas:
        out = _fused_kernel(a, w, want_q=want_q, block_rows=block_rows)
    else:
        q, g = _ref.fused_apply_gram(a, w)
        out = (q, g) if want_q else g
    g_out = out[1] if want_q else out
    q_bytes = _nbytes(out[0]) if want_q else 0
    _note("fused_apply_gram", traced, sweeps=1, read_bytes=_nbytes(a) + _nbytes(w),
          write_bytes=q_bytes + _nbytes(g_out))
    return out


def combine_gram(r1, r2, *, use_pallas: bool = False):
    """``G = R1ᵀR1 + R2ᵀR2`` in float32 for two (…, n, n) factors: the
    Gram-butterfly's combine.  Recorded as the reference records it: no
    sweep, reading both factors and writing G."""
    traced = _trace("combine_gram", (r1, r2), use_pallas=use_pallas)
    out = _combine_kernel(r1, r2) if use_pallas else _ref.combine_gram(r1, r2)
    _note("combine_gram", traced, read_bytes=_nbytes(r1) + _nbytes(r2), write_bytes=_nbytes(out))
    return out


# -- raw forms (no traffic notes) ---------------------------------------------
#
# The fixed-shape blocked-QR pipeline (repro_torch.qr.blocked) calls these
# and notes its own per-call totals, as the reference's scan-compiled
# pipeline does, its kernel traces included; launches are counted by the
# kernel wrappers either way.

def _trailing_update_raw(a, q, w, *, next_width: int = 0, use_pallas: bool = False,
                         out=None, block_rows: int | None = None):
    if use_pallas:
        return _trailing_kernel(a, q, w, next_width=next_width, out=out, block_rows=block_rows)
    res = _ref.trailing_update(a, q, w, next_width=next_width)
    if out is None:
        return res
    out.copy_(res[0] if next_width else res)
    return (out, res[1]) if next_width else out


def _panel_cross_raw(a, *, split: int, use_pallas: bool = False,
                     block_rows: int | None = None):
    if use_pallas:
        return _panel_cross_kernel(a, split=split, block_rows=block_rows)
    return _ref.panel_cross(a, split=split)


def _pad_cross_raw(a, *, split: int, out_width: int, use_pallas: bool = False,
                   block_rows: int | None = None):
    if use_pallas:
        return _pad_cross_kernel(a, split=split, out_width=out_width, block_rows=block_rows)
    return _ref.pad_cross(a, split=split, out_width=out_width)


def trailing_update(a, q, w, *, next_width: int = 0, use_pallas: bool = False,
                    block_rows: int | None = None):
    """Blocked-QR trailing update ``A − Q W`` in **one** trailing-block
    sweep, with the next panel's cross-Gram ``S`` accumulated in the same
    pass when ``next_width > 0``.  Returns ``a_new`` — or ``(a_new, s)``."""
    if use_pallas:
        block_rows = _resolve_br("trailing_update", *a.shape[-2:], a, block_rows)
    traced = _trace("trailing_update", (a, q, w), (next_width,), use_pallas=use_pallas,
                    block_rows=block_rows)
    out = _trailing_update_raw(a, q, w, next_width=next_width, use_pallas=use_pallas,
                               block_rows=block_rows)
    a_new = out[0] if next_width else out
    s_bytes = _nbytes(out[1]) if next_width else 0
    _note("trailing_update", traced, sweeps=1, read_bytes=_nbytes(a) + _nbytes(q) + _nbytes(w),
          write_bytes=_nbytes(a_new) + s_bytes)
    return out


def panel_cross(a, *, split: int, use_pallas: bool = False, block_rows: int | None = None):
    """Pipeline prime for blocked QR: ``S = A[:, :split]ᵀ A`` in one sweep."""
    if use_pallas:
        block_rows = _resolve_br("panel_cross", *a.shape[-2:], a, block_rows)
    traced = _trace("panel_cross", (a,), (split,), use_pallas=use_pallas,
                    block_rows=block_rows)
    out = _panel_cross_raw(a, split=split, use_pallas=use_pallas, block_rows=block_rows)
    _note("panel_cross", traced, sweeps=1, read_bytes=_nbytes(a), write_bytes=_nbytes(out))
    return out


def pad_cross(a, *, split: int, out_width: int, use_pallas: bool = False,
              block_rows: int | None = None):
    """Fixed-shape pipeline prime: widen A to the padded trailing width and
    compute ``S = A[:, :split]ᵀ A`` in the same single sweep.  Returns
    ``(a_pad, s)``."""
    if use_pallas:
        block_rows = _resolve_br("pad_cross", *a.shape[-2:], a, block_rows)
    traced = _trace("pad_cross", (a,), (split, out_width), use_pallas=use_pallas,
                    block_rows=block_rows)
    out = _pad_cross_raw(a, split=split, out_width=out_width, use_pallas=use_pallas,
                         block_rows=block_rows)
    _note("pad_cross", traced, sweeps=1, read_bytes=_nbytes(a),
          write_bytes=_nbytes(out[0]) + _nbytes(out[1]))
    return out


# -- composed ops -------------------------------------------------------------

def tri_inv(r: torch.Tensor) -> torch.Tensor:
    """Inverse of an upper-triangular (…, n, n) factor, in ``r``'s dtype."""
    eye = torch.eye(r.shape[-1], dtype=r.dtype, device=r.device)
    return torch.linalg.solve_triangular(r, eye, upper=True)


def _posdiag(r: torch.Tensor) -> torch.Tensor:
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    s = torch.where(d < 0, -1.0, 1.0).to(r.dtype)
    return r * s[..., :, None]


def _chol_upper(g: torch.Tensor) -> torch.Tensor:
    """Upper-triangular Cholesky factor of a Gram matrix (positive diag).

    A matrix that is not positive definite gives a factor whose triangle is
    all NaN (zeros elsewhere), as the reference's ``jnp.linalg.cholesky``
    does: ``cholesky_ex`` reports it in ``info`` without a host sync, and
    the factor is NaN-filled there.  On the card, cuSOLVER can return
    ``info`` 0 for a Gram that is indefinite by a few roundings and leave
    the square root of the negative pivot, NaN, on the diagonal, so a NaN
    pivot counts as a refusal too.
    """
    low, info = torch.linalg.cholesky_ex(g)
    pivots = torch.diagonal(low, dim1=-2, dim2=-1)
    bad = ((info != 0) | torch.isnan(pivots).any(-1))[..., None, None]
    return torch.where(bad, torch.full_like(low, float("nan")).tril(), low).mT


def _weights(r: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """R⁻¹ cast to the storage dtype, contiguous for the kernels."""
    return tri_inv(r).to(dtype).contiguous()


def cholesky_qr(a, *, use_pallas: bool = False):
    """One CholeskyQR round.  a: (…, m, n) → (Q (…, m, n), R (…, n, n) f32)."""
    r = _chol_upper(gram(a, use_pallas=use_pallas))
    q = apply_right(a, _weights(r, a.dtype), use_pallas=use_pallas)
    return q, r


def cholesky_qr2(a, *, use_pallas: bool = False, fused: bool = True):
    """CholeskyQR2: Householder-grade orthogonality for κ(A) ≲ 1/√ε.

    ``fused=True`` (default) rides :func:`fused_apply_gram`: 3 tall-operand
    sweeps (A, A, Q₁) instead of the unfused 4 (A, A, Q₁, Q₁).
    """
    if not fused:
        q1, r1 = cholesky_qr(a, use_pallas=use_pallas)
        q, r2 = cholesky_qr(q1, use_pallas=use_pallas)
        return q, _posdiag(r2 @ r1)
    r1 = _chol_upper(gram(a, use_pallas=use_pallas))                 # sweep 1
    q1, g2 = fused_apply_gram(a, _weights(r1, a.dtype),              # sweep 2
                              use_pallas=use_pallas)
    r2 = _chol_upper(g2)
    q = apply_right(q1, _weights(r2, a.dtype), use_pallas=use_pallas)  # sweep 3
    return q, _posdiag(r2 @ r1)


def cholesky_qr2_r(a, *, use_pallas: bool = False):
    """CholeskyQR2, R factor only — **2 sweeps** over the tall operand.

    The TSQR local QR: sweep 1 is the Gram of A; sweep 2 is
    :func:`fused_apply_gram` with ``want_q=False``.  Bitwise equal to
    ``cholesky_qr2(a)[1]`` (same row split, same cast points).
    """
    r1 = _chol_upper(gram(a, use_pallas=use_pallas))                 # sweep 1
    g2 = fused_apply_gram(a, _weights(r1, a.dtype),                  # sweep 2
                          use_pallas=use_pallas, want_q=False)
    r2 = _chol_upper(g2)
    return _posdiag(r2 @ r1)
