"""Paper §III — communication accounting per combiner (the port of
:mod:`repro.bench.cases.comm_volume`): baseline TSQR vs the redundant
variants, messages, serial rounds and bytes (square and, for symmetric
``gram_sum`` payloads, packed), and the failure-time overhead of Replace
and Self-Healing.

The case also *executes* the plans on ``device`` (``None``: the card)
through :class:`~repro_torch.collective.instrument.InstrumentedComm` and
gates on observed-vs-planned agreement: the fault-free fast path (payload
only), the general executor (+1 validity byte per message), the packed
symmetric wire, stacked multi-leaf payloads and faulty plans with restore
rounds.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.registry import bench_case
from repro_torch.bench.schema import Metric
from repro_torch.collective import FaultSpec, get_combiner, make_plan

_OPS = ("qr_combine", "sum", "mean", "max", "gram_sum")

__all__ = ["case", "run"]


def _row(p, variant, failures, plan, op, n_cols, itemsize):
    comb = get_combiner(op)
    sq = plan.bytes_on_wire(n_cols, itemsize)
    packed = plan.bytes_on_wire(n_cols, itemsize, symmetric=True)
    return {
        "P": p, "variant": variant, "failures": failures, "combiner": comb.name,
        "messages": plan.message_count(),
        "rounds": plan.round_count(),
        "bytes": sq,
        "bytes_packed": packed if comb.wire_symmetric else sq,
    }


def run(n_cols: int = 32, itemsize: int = 4, ops=_OPS):
    rows = []
    for p in (4, 16, 64, 256, 512):
        for variant in ("tree", "redundant", "replace", "selfhealing"):
            plan = make_plan(variant, p)
            for op in ops:
                rows.append(_row(p, variant, 0, plan, op, n_cols, itemsize))
    spec = FaultSpec.of({3: 1, 9: 2, 12: 2})
    for variant in ("redundant", "replace", "selfhealing"):
        plan = make_plan(variant, 16, spec)
        for op in ops:
            rows.append(_row(16, variant, 3, plan, op, n_cols, itemsize))
    return rows


def _observer(p: int, device):
    from repro_torch.collective import InstrumentedComm, SimComm, execute_plan

    def observed(payload, plan, op, fast):
        ic = InstrumentedComm(SimComm(p, device))
        execute_plan(payload, ic, plan, op, fast=fast)
        return ic.stats

    return observed


def _on(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(x).to(device)


def _observed_matches_plan(p: int, n_cols: int, device) -> bool:
    """Execute each plan with counting comms and compare to the planner's
    accounting (see the module docstring)."""
    from repro_torch.collective.comm import resolve_device

    device = resolve_device(device)
    observed = _observer(p, device)
    x_np = np.random.default_rng(0).normal(size=(p, n_cols, n_cols)).astype(np.float32)
    x = _on(x_np, device)
    sym = _on(np.einsum("pmi,pmj->pij", x_np, x_np), device)

    for variant in ("tree", "redundant", "replace", "selfhealing"):
        plan = make_plan(variant, p)
        st = observed(x, plan, "sum", None)
        expect = plan.bytes_on_wire(n_cols, 4)
        if plan.is_fault_free:
            if st.payload_bytes != expect:
                return False
        elif st.payload_bytes != expect + plan.message_count():
            return False
        if st.messages != plan.message_count() or st.rounds != plan.round_count():
            return False
        st = observed(x, plan, "sum", False)
        if st.payload_bytes != expect + plan.message_count():
            return False
        st = observed(sym, plan, "gram_sum", None)
        packed = plan.bytes_on_wire(n_cols, 4, symmetric=True)
        if plan.is_fault_free:
            if st.payload_bytes != packed:
                return False
        elif st.payload_bytes != packed + plan.message_count():
            return False
    spec = FaultSpec.of({3: 1, 5: 2})
    for variant in ("redundant", "replace", "selfhealing"):
        plan = make_plan(variant, p, spec)
        st = observed(x, plan, "sum", None)
        if st.messages != plan.message_count() or st.rounds != plan.round_count():
            return False
        if st.payload_bytes != plan.bytes_on_wire(n_cols, 4) + plan.message_count():
            return False
    return _observed_matches_plan_stacked(p, n_cols, device)


def _observed_matches_plan_stacked(p: int, n_cols: int, device) -> bool:
    """Stacked / mixed multi-leaf payloads: the symmetric leaf ships packed
    and the rectangular leaf dense in the same message, priced by
    ``Plan.bytes_on_wire_stacked``; ``gram_sum`` over a mixed tree (a list:
    the port's payload trees are tuples and lists, the reference's dict
    here) packs only the square leaf."""
    from repro_torch.collective import stacked

    observed = _observer(p, device)
    rng = np.random.default_rng(1)
    x_np = rng.normal(size=(p, n_cols, n_cols)).astype(np.float32)
    sym = _on(np.einsum("pmi,pmj->pij", x_np, x_np), device)
    rect = _on(rng.normal(size=(p, n_cols, 2 * n_cols)).astype(np.float32), device)
    fused = stacked("gram_sum", "sum")
    leaves = [(n_cols, n_cols, 4, True), (n_cols, 2 * n_cols, 4, False)]
    for variant in ("tree", "redundant", "replace", "selfhealing"):
        plan = make_plan(variant, p)
        expect = plan.bytes_on_wire_stacked(leaves)
        st = observed((sym, rect), plan, fused, None)
        validity = 0 if plan.is_fault_free else plan.message_count()
        if st.payload_bytes != expect + validity or st.messages != plan.message_count():
            return False
        st = observed((sym, rect), plan, fused, False)
        if st.payload_bytes != expect + plan.message_count():
            return False
        st = observed([sym, rect], plan, "gram_sum", None)   # the port's trees are lists
        if st.payload_bytes != expect + validity:
            return False
    return True


def case(n_cols: int = 32, itemsize: int = 4, observe_p: int = 16, device=None):
    rows = run(n_cols=n_cols, itemsize=itemsize)
    by = {(r["P"], r["variant"], r["failures"], r["combiner"]): r for r in rows}
    hard = dict(gate="hard", direction="exact")
    metrics = {}
    for p in (16, 512):
        tree = by[(p, "tree", 0, "qr_combine")]
        red = by[(p, "redundant", 0, "qr_combine")]
        metrics[f"tree_messages_P{p}"] = Metric(tree["messages"], **hard)
        metrics[f"redundant_messages_P{p}"] = Metric(red["messages"], **hard)
        metrics[f"latency_parity_P{p}"] = Metric(red["rounds"] == tree["rounds"], **hard)
    metrics["redundant_bytes_P16"] = Metric(
        by[(16, "redundant", 0, "qr_combine")]["bytes"], **hard, unit="B")
    metrics["gram_packed_bytes_P16"] = Metric(
        by[(16, "redundant", 0, "gram_sum")]["bytes_packed"], **hard, unit="B")
    for variant in ("replace", "selfhealing"):
        base = by[(16, variant, 0, "sum")]
        f3 = by[(16, variant, 3, "sum")]
        metrics[f"{variant}_extra_rounds_f3"] = Metric(
            f3["rounds"] - base["rounds"], gate="hard", direction="lower")
        metrics[f"{variant}_extra_messages_f3"] = Metric(
            f3["messages"] - base["messages"], gate="hard", direction="lower")
    metrics["observed_matches_plan"] = Metric(
        _observed_matches_plan(observe_p, n_cols, device), **hard)
    return metrics


bench_case(
    "comm_volume",
    tags=("comm", "accounting"),
    params={
        "smoke": {"n_cols": 32, "itemsize": 4, "observe_p": 16},
        "full": {"n_cols": 32, "itemsize": 4, "observe_p": 64},
    },
)(case)
