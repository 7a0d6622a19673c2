"""Checksum-coded redundancy: the second fault-tolerance scheme.

The port of :mod:`repro.collective.coded`.  The butterfly buys its
``2^s − 1`` tolerance with replication; here the ``P`` data ranks are
augmented with ``c`` checksum ranks, each holding a fixed linear combination
(*parity*) of the prepared per-rank contributions:

    ``p_j = Σ_i w_{ji} · prepare(x_i)``            (j = 0 .. c−1)

The weights are a Cauchy matrix (``w_{ji} = 1 / (P + j − i)``), so every
square submatrix is nonsingular: any ℓ ≤ c lost contributions can be
re-solved from any ℓ surviving parity lanes.  The parity is encoded when
the data is distributed, before any fault, and costs no priced wire.

One coded reduction is four host-planned phases over the ``W = P + c``
world (:func:`execute_coded`, each phase its own ``comm.exchange``, so
:class:`~repro_torch.collective.instrument.InstrumentedComm` observes
exactly what :meth:`CodedPlan.bytes_on_wire` prices):

  1. *gather* — a binomial tree over the ``S`` surviving data ranks to a
     root, carrying the running combine plus ℓ reconstruction lanes
     ``q_j = Σ_{i∈S} w_{ji} prepare(x_i)``.  For ℓ = 0 this is the same
     balanced combine tree as the butterfly, so the fault-free result is
     bitwise equal to it.
  2. *parity sends* — the ℓ chosen parity lanes send ``p_j`` to the root;
     ``p_j − q_j`` restricts the checksum to the lost contributions.
  3. *raw sends* — each declared-corrupt rank forwards its raw contribution
     to the root, whose compare against the reconstruction *detects* it.
  4. *broadcast* — the root solves the ℓ×ℓ Cauchy system (host float64
     coefficients applied as Python scalars), absorbs the reconstructed
     contributions and broadcasts the result to every data rank and every
     alive parity rank.

Deaths (even before any exchange), stragglers (``FaultSpec.slow``) and
declared corruptions (``FaultSpec.corrupt``) are erasures; more erasures
than usable parity lanes, or no data survivor, make the plan unrecoverable:
every rank ends ``valid=False`` with NaN payloads.

On one card every rank is a row of a (W,)-leading tensor
(:class:`~repro_torch.collective.comm.SimComm`).  The routing is
host-static, and ``detected`` stays a device tensor: a coded reduction
reads nothing back to the host.  :func:`coded_allreduce_jit` runs one as a
cached program (:mod:`repro_torch.replay`: a CUDA graph on the card).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import replay
from repro_torch.kernels import dispatch as _dispatch

from ._tree import leaves, structure, tree_map, unflatten
from .combiners import Combiner, get_combiner
from .comm import Comm, DistComm, SimComm, check_device
from .engine import _poison, _wire_codec
from .faults import FaultSpec
from .instrument import InstrumentedComm
from .plan import leaf_bytes, payload_numel

__all__ = [
    "CodedCombiner",
    "CodedPlan",
    "coded_allreduce",
    "coded_allreduce_jit",
    "coded_weights",
    "encode_parity",
    "execute_coded",
    "make_coded_plan",
    "reconstruction_tol",
]

Pair = tuple[int, int]


def coded_weights(n_data: int, n_parity: int) -> np.ndarray:
    """The ``(c, P)`` Cauchy checksum-weight matrix ``w_{ji} = 1/(P+j−i)``:
    every square submatrix is nonsingular, and the entries lie in
    ``(0, 1]``, so parity stays at the payload's magnitude."""
    a = np.arange(n_data, n_data + n_parity, dtype=np.float64)
    b = np.arange(n_data, dtype=np.float64)
    return 1.0 / (a[:, None] - b[None, :])


def reconstruction_tol(dtype) -> float:
    """The fp bound of parity reconstruction relative to the payload's
    magnitude, ``sqrt(eps) · 8`` with the root taken in ``dtype`` (as the
    reference takes it); also the threshold that separates fp noise from
    corruption in the checksum verification.  ``dtype`` is a torch or
    numpy dtype."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype
    eps = torch.tensor(torch.finfo(dtype).eps, dtype=dtype)
    return float(torch.sqrt(eps) * 8.0)


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class CodedPlan:
    """Host-computed static routing for one coded reduction, equal to the
    reference's field by field.

    ``erased`` is the union of dead, slow and corrupt *data* ranks (all
    reconstructed from parity); ``parity_used`` the global ids of the lanes
    consumed; ``decode[e, t]`` the float64 coefficient of deficit ``t`` in
    the reconstruction of ``erased[e]``.
    """

    n_data: int
    n_parity: int
    death: np.ndarray            # (W,) effective death vector consumed
    erased: tuple[int, ...]      # data ranks reconstructed from parity
    corrupt: tuple[int, ...]     # alive data ranks verified against parity
    slow: tuple[int, ...]        # stragglers (reconstructed, not awaited)
    survivors: tuple[int, ...]   # data ranks in the gather tree
    parity_used: tuple[int, ...]  # global rank ids of consumed parity lanes
    root: int
    gather_rounds: tuple[tuple[Pair, ...], ...]
    bcast_rounds: tuple[tuple[Pair, ...], ...]
    final_valid: np.ndarray      # (W,) who holds the final value
    weights: np.ndarray          # (c, P) float64 checksum weights
    decode: np.ndarray           # (l, l) float64 erasure-decode coefficients
    recoverable: bool

    @functools.cached_property
    def _sig(self) -> tuple:
        return (
            self.n_data,
            self.n_parity,
            self.death.tobytes(),
            self.erased,
            self.corrupt,
            self.slow,
            self.survivors,
            self.parity_used,
            self.root,
            self.gather_rounds,
            self.bcast_rounds,
            self.final_valid.tobytes(),
            self.weights.tobytes(),
            self.decode.tobytes(),
            self.recoverable,
        )

    def __eq__(self, other) -> bool:
        return isinstance(other, CodedPlan) and self._sig == other._sig

    def __hash__(self) -> int:
        return hash(self._sig)

    @property
    def n_ranks(self) -> int:
        """World size ``W = P + c`` (the comm the plan executes over)."""
        return self.n_data + self.n_parity

    @property
    def n_erased(self) -> int:
        return len(self.erased)

    @functools.cached_property
    def is_fault_free(self) -> bool:
        return self.recoverable and not self.erased

    # -- communication accounting ---------------------------------------------
    def message_count(self) -> int:
        """Gather + parity sends + raw sends + broadcast messages; zero when
        unrecoverable (nothing ships)."""
        if not self.recoverable:
            return 0
        return (len(self.survivors) - 1 + len(self.parity_used) + len(self.corrupt)
                + self._n_bcast())

    def round_count(self) -> int:
        """Serial rounds; parity and raw sends serialize (all target the
        root)."""
        if not self.recoverable:
            return 0
        return (len(self.gather_rounds) + len(self.parity_used) + len(self.corrupt)
                + len(self.bcast_rounds))

    def _n_bcast(self) -> int:
        return sum(len(r) for r in self.bcast_rounds)

    def payload_units(self) -> int:
        """Messages weighted by payload multiplicity: a gather message
        carries the result plus ℓ lanes, ``(1+ℓ)`` units; every other
        message one."""
        if not self.recoverable:
            return 0
        l = len(self.erased)
        return ((len(self.survivors) - 1) * (1 + l) + len(self.parity_used)
                + len(self.corrupt) + self._n_bcast())

    def bytes_on_wire(self, n_cols: int, itemsize: int = 4, *, symmetric: bool = False) -> int:
        """Total payload bytes of an (n, n) payload, weighted per message by
        :meth:`payload_units`."""
        return self.payload_units() * payload_numel(n_cols, symmetric) * itemsize

    def bytes_on_wire_stacked(self, leaves) -> int:
        """Exact wire bytes of a multi-leaf payload; ``leaves`` are
        ``(rows, cols, itemsize, symmetric)`` specs."""
        return self.payload_units() * sum(leaf_bytes(*spec) for spec in leaves)


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def _binomial_gather(members: list[int]) -> tuple[tuple[Pair, ...], ...]:
    """Binomial gather to ``members[0]``; the receiver of every pair has the
    lower list index, so the combine is the butterfly's balanced in-order
    tree."""
    rounds: list[tuple[Pair, ...]] = []
    n, s = len(members), 0
    while (1 << s) < n:
        pairs = [
            (members[i + (1 << s)], members[i])
            for i in range(0, n, 2 << s)
            if i + (1 << s) < n
        ]
        rounds.append(tuple(pairs))
        s += 1
    return tuple(rounds)


def _binomial_bcast(members: list[int]) -> tuple[tuple[Pair, ...], ...]:
    """Binomial broadcast from ``members[0]``: coverage doubles per round,
    ``len(members) − 1`` messages, unique sources and destinations."""
    rounds: list[tuple[Pair, ...]] = []
    n, have = len(members), 1
    while have < n:
        rounds.append(tuple(
            (members[i], members[i + have]) for i in range(min(have, n - have))
        ))
        have *= 2
    return tuple(rounds)


@functools.lru_cache(maxsize=512)
def _make_coded_plan_cached(n_data: int, n_parity: int, spec: FaultSpec) -> CodedPlan:
    w = n_data + n_parity
    death = spec.death_vector(w)
    # No butterfly steps: a listed death, whatever its step, is absent for
    # the whole reduction (parity was encoded before any death).
    dead = {r for r, _ in spec.deaths}
    slow = set(spec.slow)
    corrupt = set(spec.corrupt)
    for kind, rs in (("corrupt", corrupt), ("slow", slow)):
        bad = [r for r in rs if r >= w]
        if bad:
            raise ValueError(f"{kind} ranks {bad} out of range for W={w}")
    weights = coded_weights(n_data, n_parity)
    # usable parity lanes: alive, on time and uncorrupted
    parity_ok = [
        r for r in range(n_data, w)
        if r not in dead and r not in slow and r not in corrupt
    ]
    erased = tuple(sorted(
        i for i in range(n_data) if i in dead or i in slow or i in corrupt
    ))
    corrupt_data = tuple(sorted(i for i in range(n_data) if i in corrupt))
    survivors = tuple(i for i in range(n_data) if i not in set(erased))
    l = len(erased)
    # The reference's verdict, kept so that plans are equal: a decode also
    # needs a live data rank to root the gather (ROADMAP C2).
    recoverable = l <= len(parity_ok) and len(survivors) > 0
    if not recoverable:
        return CodedPlan(
            n_data=n_data, n_parity=n_parity, death=death, erased=erased,
            corrupt=corrupt_data, slow=tuple(sorted(slow)),
            survivors=survivors, parity_used=(), root=-1,
            gather_rounds=(), bcast_rounds=(),
            final_valid=np.zeros(w, dtype=bool), weights=weights,
            decode=np.zeros((0, 0)), recoverable=False,
        )
    parity_used = tuple(parity_ok[:l])
    root = survivors[0]
    # every data rank (dead ones are respawned into the result) plus every
    # alive parity rank
    recips = [r for r in range(w) if r != root and (r < n_data or r not in dead)]
    if l:
        sub = weights[
            np.array([p - n_data for p in parity_used], dtype=np.intp)[:, None],
            np.array(erased, dtype=np.intp)[None, :],
        ]
        decode = np.linalg.inv(sub)
    else:
        decode = np.zeros((0, 0))
    final_valid = np.ones(w, dtype=bool)
    for r in range(n_data, w):
        final_valid[r] = r not in dead
    return CodedPlan(
        n_data=n_data, n_parity=n_parity, death=death, erased=erased,
        corrupt=corrupt_data, slow=tuple(sorted(slow)),
        survivors=survivors, parity_used=parity_used, root=root,
        gather_rounds=_binomial_gather(list(survivors)),
        bcast_rounds=_binomial_bcast([root] + recips),
        final_valid=final_valid, weights=weights, decode=decode,
        recoverable=True,
    )


def make_coded_plan(n_data: int, n_parity: int, fault_spec: FaultSpec | None = None) -> CodedPlan:
    """Host-plan a coded reduction over ``n_data`` data + ``n_parity``
    checksum ranks, memoized on ``(P, c, spec)``."""
    if n_data < 1:
        raise ValueError(f"need at least one data rank, got {n_data}")
    if n_parity < 1:
        raise ValueError(f"coded redundancy needs at least one parity rank, got {n_parity}")
    return _make_coded_plan_cached(n_data, n_parity, fault_spec or FaultSpec.none())


# ---------------------------------------------------------------------------
# Encode / decode combiner family
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _device_weights(data: bytes, shape: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    host = np.frombuffer(data, dtype=np.float64).reshape(shape)
    return torch.from_numpy(host.copy()).to(dtype).to(device)


def _weights_like(host: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    """Host float64 weights rounded to the leaf's dtype (as the reference
    casts them), on the leaf's device, copied there once per value: a copy
    from pageable host memory would stall the host until the card caught
    up with everything queued before it."""
    return _device_weights(host.tobytes(), host.shape, leaf.dtype, leaf.device)


def encode_parity(prepared, plan: CodedPlan):
    """The (W,)-leading payload of a (P,)- or (W,)-leading prepared one:
    its ``P`` data rows followed by the ``c`` checksum combinations of
    them (any parity rows given are replaced).

    The products and their sum over the ``P`` data rows run elementwise, in
    float32 at least (bf16 leaves too): a matrix product could take TF32 on
    the card, which would coarsen the decode and invite false detections.
    """
    p = plan.n_data

    def enc(leaf):
        acc = torch.promote_types(leaf.dtype, torch.float32)
        wts = _weights_like(plan.weights, leaf).to(acc)
        wts = wts.reshape(wts.shape + (1,) * (leaf.ndim - 1))
        parity = (wts * leaf[:p].to(acc)[None]).sum(dim=1)
        return torch.cat([leaf[:p], parity.to(leaf.dtype)], dim=0)

    return tree_map(enc, prepared)


def _data_rows(x, plan: CodedPlan):
    """The ``P`` data rows of a (P,)- or (W,)-leading payload."""
    def take(leaf):
        if leaf.shape[0] == plan.n_data:
            return leaf
        if leaf.shape[0] == plan.n_ranks:
            return leaf[: plan.n_data]
        raise ValueError(
            f"payload leading axis {leaf.shape[0]} matches neither P="
            f"{plan.n_data} nor W={plan.n_ranks}"
        )

    return tree_map(take, x)


@dataclasses.dataclass(frozen=True)
class CodedCombiner(Combiner):
    """Encode / reduce / decode on the tree-payload protocol, over any
    inner combiner (sum, mean, max, gram_sum, qr, stacked tuples).

    ``tree_prepare`` runs the inner prepare on the ``P`` data rows only and
    appends the parity rows the encode computes.  The reference zero-pads
    the input to W rows, prepares all of them and then overwrites the
    parity rows, so the values are the same; preparing the data rows alone
    copies no tall operand and hands the kernels the butterfly's batch, so
    their row split, and with it the data rows' bits, equal the
    butterfly's.
    """

    inner: Combiner = None  # type: ignore[assignment]
    plan: CodedPlan = None  # type: ignore[assignment]
    name = "coded"

    def __post_init__(self):
        if self.inner is None or self.plan is None:
            raise ValueError("CodedCombiner needs an inner combiner and a plan")

    # -- tree-payload protocol ------------------------------------------------
    def prepare_data(self, x):
        """The inner prepare of the ``P`` data rows alone."""
        return self.inner.tree_prepare(_data_rows(x, self.plan))

    def tree_prepare(self, x):
        return encode_parity(self.prepare_data(x), self.plan)

    def tree_combine(self, lo, hi):
        return self.inner.tree_combine(lo, hi)

    def tree_finalize(self, x, n_ranks: int):
        return self.inner.tree_finalize(x, self.plan.n_data)

    def wire_pack_flags(self, val) -> list[bool]:
        return self.inner.wire_pack_flags(val)

    # -- the per-leaf protocol has no meaning (the encode is positional) -----
    def prepare(self, x):
        raise TypeError("CodedCombiner operates at tree level")

    def combine(self, lo, hi):
        raise TypeError("CodedCombiner operates at tree level")

    def finalize(self, x, n_ranks: int):
        raise TypeError("CodedCombiner operates at tree level")

    # -- coded-specific algebra -----------------------------------------------
    def make_lanes(self, val):
        """Per-rank reconstruction lanes: leaf ``(W, ...)`` → ``(W, ℓ, ...)``
        with lane ``t`` holding ``w_{t,i} · val_i`` on survivor rows (zero on
        erased and parity rows)."""
        plan = self.plan
        w_, l = plan.n_ranks, len(plan.erased)
        lane_w = np.zeros((w_, l))
        for t, pr in enumerate(plan.parity_used):
            lane_w[: plan.n_data, t] = plan.weights[pr - plan.n_data]
        lane_w[list(plan.erased), :] = 0.0

        def mk(leaf):
            wv = _weights_like(lane_w, leaf).reshape((w_, l) + (1,) * (leaf.ndim - 1))
            return leaf[:, None] * wv

        return tree_map(mk, val)

    def lane_combine(self, acc, recv):
        """Lanes are weighted sums: combine by addition."""
        return tree_map(torch.add, acc, recv)

    def decode_erased(self, deficits):
        """Solve the erasure system: ``deficits[t] = p_t − q_t`` →
        ``{erased_rank: reconstructed contribution}``, with the host float64
        coefficients applied as Python scalars."""
        dec = self.plan.decode
        out = {}
        for e_idx, er in enumerate(self.plan.erased):
            acc = None
            for t in range(len(deficits)):
                term = tree_map(lambda d, c=float(dec[e_idx, t]): c * d, deficits[t])
                acc = term if acc is None else tree_map(torch.add, acc, term)
            out[er] = acc
        return out

    def absorb(self, res, reconstructed):
        """Fold the reconstructed contributions into the survivor result in
        erased-rank order (the documented fp deviation from fault-free)."""
        for er in self.plan.erased:
            res = self.inner.tree_combine(res, reconstructed[er])
        return res

    def verify(self, raw, reconstructed):
        """Does a declared-corrupt rank's raw payload disagree with its
        parity reconstruction beyond fp noise?  A device bool."""
        err = scale = None
        for a, b in zip(leaves(raw), leaves(reconstructed)):
            e = (a - b).abs().max()
            s = b.abs().max()
            err = e if err is None else torch.maximum(err, e)
            scale = s if scale is None else torch.maximum(scale, s)
        tol = max(reconstruction_tol(leaf.dtype) for leaf in leaves(raw))
        return err > tol * (scale + 1.0)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

def _check_inexact(x) -> None:
    for leaf in leaves(x):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            raise TypeError(
                "coded redundancy requires an inexact payload dtype (the "
                f"checksum weights are non-integer), got {leaf.dtype}"
            )


def _base_comm(comm: Comm) -> Comm:
    return comm.inner if isinstance(comm, InstrumentedComm) else comm


def execute_coded(x, comm: Comm, plan: CodedPlan, combiner: Combiner | str, *, observed=None):
    """Run one coded reduction.  Returns ``(value, valid, detected)``.

    ``x`` is a tree of per-rank payloads with a leading ``(P,)`` or
    ``(W,)`` axis (parity rows are recomputed by the encode either way).
    ``value`` is the un-finalized combine on every valid rank; ``valid``
    the host-predicted validity (``plan.final_valid``) on the device;
    ``detected`` a ``(W,)`` device bool flagging ranks whose payload failed
    checksum verification.  Each phase issues its own exchanges, so
    observed traffic equals ``plan.bytes_on_wire{,_stacked}`` exactly.

    ``observed`` models silent data corruption: parity is encoded from
    ``x`` (the truth at distribution time), while the data ranks contribute
    from ``observed`` (what they hold now; defaults to ``x``), so detection
    is a numerical compare, not an echo of the fault spec.
    """
    inner = get_combiner(combiner)
    if isinstance(inner, CodedCombiner):
        coded, inner = inner, inner.inner
    else:
        coded = CodedCombiner(inner=inner, plan=plan)
    if isinstance(_base_comm(comm), DistComm):
        raise ValueError(
            "coded collectives execute on the SimComm backend only: the "
            "root-side decode indexes rank rows of the (W,)-leading layout"
        )
    w_ = plan.n_ranks
    if comm.n_ranks != w_:
        raise ValueError(
            f"comm has {comm.n_ranks} ranks but the plan's world is "
            f"W = {plan.n_data} + {plan.n_parity} = {w_}"
        )
    x = _data_rows(x, plan)
    _check_inexact(x)
    check_device(x, comm)
    if observed is not None:
        check_device(observed, comm)
    val = coded.tree_prepare(x)
    if observed is not None:
        # data rows contribute what the ranks hold now; parity rows keep the
        # distribution-time encode of the truth
        p = plan.n_data
        vobs = coded.prepare_data(observed)
        val = tree_map(lambda t, o: torch.cat([o, t[p:]], dim=0), val, vobs)
    detected = torch.zeros((w_,), dtype=torch.bool, device=leaves(val)[0].device)
    if not plan.recoverable:
        # honest degradation: nothing ships, everything is poisoned
        return tree_map(_poison, val), comm.take(plan.final_valid), detected
    pack, unpack = _wire_codec(inner, val)
    l = len(plan.erased)
    root = plan.root
    # -- phase 1: binomial gather over survivors, result + ℓ lanes -------------
    lanes = None
    if l:
        lanes = coded.make_lanes(val)
        lpack, lunpack = _wire_codec(inner, lanes)
    for pairs in plan.gather_rounds:
        got = np.zeros(w_, dtype=bool)
        got[[d for _, d in pairs]] = True
        g = comm.take(got)
        if l:
            rv, rl = comm.exchange((pack(val), lpack(lanes)), pairs)
            lanes = coded.lane_combine(lanes, lunpack(rl))
        else:
            rv = comm.exchange(pack(val), pairs)
        comb = coded.tree_combine(val, unpack(rv))          # the receiver is lo
        val = tree_map(lambda c, v: comm.bwhere(g, c, v), comb, val)
    # -- phase 2: parity sends → deficits p_t − q_t ----------------------------
    deficits = []
    for t, pr in enumerate(plan.parity_used):
        rv = unpack(comm.exchange(pack(val), ((pr, root),)))
        deficits.append(tree_map(lambda r, ln, t=t: r[root] - ln[root, t], rv, lanes))
    # -- phase 3: raw sends from declared-corrupt ranks ------------------------
    raws = {}
    for ci in plan.corrupt:
        rv = unpack(comm.exchange(pack(val), ((ci, root),)))
        raws[ci] = tree_map(lambda r: r[root], rv)
    # -- decode + absorb + verify (root-local, no wire) ------------------------
    res = tree_map(lambda v: v[root], val)
    if l:
        reconstructed = coded.decode_erased(deficits)
        res = coded.absorb(res, reconstructed)
        if plan.corrupt:
            detected = detected.clone()
            for ci in plan.corrupt:
                detected[ci] = coded.verify(raws[ci], reconstructed[ci])

    def set_root(v, r):
        v = v.clone()
        v[root] = r
        return v

    val = tree_map(set_root, val, res)
    # -- phase 4: binomial broadcast root → all recipients ---------------------
    for pairs in plan.bcast_rounds:
        got = np.zeros(w_, dtype=bool)
        got[[d for _, d in pairs]] = True
        g = comm.take(got)
        rv = unpack(comm.exchange(pack(val), pairs))
        val = tree_map(lambda r, v: comm.bwhere(g, r, v), rv, val)
    # dead parity rows never receive: poison them so accidental use is loud
    fv = comm.take(plan.final_valid)
    val = tree_map(lambda v: comm.bwhere(fv, v, _poison(v)), val)
    return val, fv, detected


def coded_allreduce(x, comm: Comm, *, op: Combiner | str = "sum", n_parity: int | None = None,
                    fault_spec: FaultSpec | None = None, plan: CodedPlan | None = None,
                    observed=None):
    """Checksum-coded fault-tolerant all-reduce over the ``W = P + c``
    world of ``comm``.  Pass a prebuilt ``plan`` or ``n_parity`` (with an
    optional ``fault_spec`` in world coordinates).  Returns ``(value,
    valid, detected)`` with the finalized reduction of the ``P`` data
    contributions on every valid rank.  ``observed``: see
    :func:`execute_coded`."""
    if plan is None:
        if n_parity is None:
            raise ValueError("coded_allreduce needs a plan or n_parity")
        plan = make_coded_plan(comm.n_ranks - n_parity, n_parity, fault_spec)
    combiner = get_combiner(op)
    val, valid, detected = execute_coded(x, comm, plan, combiner, observed=observed)
    return combiner.tree_finalize(val, plan.n_data), valid, detected


def coded_allreduce_jit(x, comm: Comm, *, op: Combiner | str = "sum",
                        n_parity: int | None = None, fault_spec: FaultSpec | None = None,
                        plan: CodedPlan | None = None, observed=None):
    """:func:`coded_allreduce` as a cached program, with the contract of
    :func:`~repro_torch.collective.engine.ft_allreduce_jit`: one per (comm,
    plan, combiner, payload and ``observed`` structures) and the shapes,
    dtypes and device, a repeat call builds nothing
    (``trace_count("coded_allreduce")``), and each call counts one
    ``coded_allreduce`` dispatch.  SimComm only."""
    if not isinstance(comm, SimComm):
        raise ValueError(
            "coded_allreduce_jit builds a standalone program, which only the SimComm "
            f"backend supports; got {type(comm).__name__}"
        )
    if plan is None:
        if n_parity is None:
            raise ValueError("coded_allreduce_jit needs a plan or n_parity")
        plan = make_coded_plan(comm.n_ranks - n_parity, n_parity, fault_spec)
    combiner = get_combiner(op)
    struct = structure(x)
    o_struct = None if observed is None else structure(observed)
    flat = leaves(x)
    o_flat = [] if observed is None else leaves(observed)

    def body(*args):
        obs = None if observed is None else unflatten(o_struct, args[len(flat):])
        return coded_allreduce(unflatten(struct, args[:len(flat)]), comm, op=combiner,
                               plan=plan, observed=obs)

    _dispatch.note_dispatch("coded_allreduce")
    return replay.run("coded_allreduce", (comm, plan, combiner), body, tuple(flat + o_flat),
                      layout=(struct, o_struct))
