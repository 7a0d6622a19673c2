"""One butterfly per panel — fused stacked-payload reduction, hard-gated (the
port of :mod:`repro.bench.cases.overlap`), on ``device`` (``None``: the
card).

The panel-R butterfly and the ``W = R^-T ΣA_p^T A_t`` sum butterfly ride the
*same* routing plan, so fusing them into one collective over a stacked
``(R, C)`` payload halves the per-panel serial rounds from ``2·log2 P`` to
``log2 P`` while the replica copies keep protecting *both* results (one
``replica_fetch`` restores the pair).  The case gates:

  * **rounds** — the fused driver spends exactly ``K·log2 P`` collective
    rounds on panel reductions against the two-butterfly driver's
    ``(2K−1)·log2 P``; both hard-gated exactly;
  * **wire bytes** — fusion halves rounds and messages, *not* payload: the
    stacked wire bytes must equal the split drivers' total exactly, and the
    engine-observed bytes of a fused panel reduction must equal
    ``Plan.bytes_on_wire_stacked`` to the byte (measured through
    :class:`~repro_torch.collective.instrument.InstrumentedComm`);
  * **overlap** — the double-buffered schedule issues panel k+1's fused
    reduction before panel k's trailing sweep: all ``K−1`` steady-state
    panels overlap (``fuse="off"`` reports 0);
  * **program model** — the fused pipeline stays ONE cached program, zero
    warm retraces, and matches the eager two-butterfly driver to f32
    tolerance (hard), bitwise identity recorded warn-gated;
  * **p50** — fused vs two-butterfly wall clock, warn-gated, each call
    ending in a synchronize on the card.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench.registry import BenchFailure, bench_case
from repro_torch.bench.schema import Metric

from .dispatch import _bitwise, _sync

__all__ = ["EAGER_TOL", "case", "main", "run"]

EAGER_TOL = 1e-5          # rel. agreement of the fused pipeline vs the eager driver


def _stacked_wire_exact(p: int, b: int, n_trail: int, device) -> bool:
    """Execute the fused panel combiner through counting comms on every
    fault-free variant; the observed payload bytes must equal
    ``Plan.bytes_on_wire_stacked`` over the two dense leaves (R is shipped
    square, C rectangular) — plus 1 validity byte per message off the fast
    path — and rounds/messages must match the plan's accounting."""
    from repro_torch.collective import InstrumentedComm, SimComm, execute_plan, make_plan
    from repro_torch.qr.panel import FUSED_PANEL_COMBINER

    rng = np.random.default_rng(2)
    r_loc = torch.from_numpy(rng.standard_normal((p, b, b)).astype(np.float32)).to(device)
    c_loc = torch.from_numpy(rng.standard_normal((p, b, n_trail)).astype(np.float32)).to(device)
    leaves = [(b, b, 4, False), (b, n_trail, 4, False)]
    for variant in ("tree", "redundant", "replace", "selfhealing"):
        plan = make_plan(variant, p)
        expect = plan.bytes_on_wire_stacked(leaves)
        ic = InstrumentedComm(SimComm(p, device))
        execute_plan((r_loc, c_loc), ic, plan, FUSED_PANEL_COMBINER, fast=None)
        validity = 0 if plan.is_fault_free else plan.message_count()
        if ic.stats.payload_bytes != expect + validity:
            return False
        if ic.stats.messages != plan.message_count():
            return False
        if ic.stats.rounds != plan.round_count():
            return False
    return True


def run(p: int = 4, m_local: int = 160, n: int = 96, panel_width: int = 32,
        use_pallas: bool = True, repeats: int = 9, device=None) -> dict:
    """Measure rounds / wire bytes / overlap / traces for the fused and
    two-butterfly drivers; return the raw numbers."""
    from repro_torch import replay
    from repro_torch.collective.comm import resolve_device
    from repro_torch.kernels import dispatch as disp
    from repro_torch.kernels import traffic
    from repro_torch.qr import blocked_qr_sim
    from repro_torch.qr.blocked import PIPELINE_NAME

    device = resolve_device(device)
    # Deterministic cold-call counts whatever ran earlier in this process
    # (see repro_torch.bench.cases.dispatch).
    replay.clear(PIPELINE_NAME)

    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((p, m_local, n)).astype(np.float32)).to(device)
    kw = dict(panel_width=panel_width, compute_q=True, use_pallas=use_pallas, device=device)
    k_panels = -(-n // panel_width)
    log_p = int(np.log2(p))

    # -- eager two-butterfly reference: the f32/bitwise oracle --------------
    eager = blocked_qr_sim(a, pipeline="off", fuse="off", **kw)

    # -- fused pipeline: cold call, rounds/overlap/wire accounting ----------
    t0 = disp.trace_count(PIPELINE_NAME)
    with disp.track_dispatch() as d_cold, traffic.track_traffic() as t_fused:
        fused = blocked_qr_sim(a, pipeline="on", fuse="auto", **kw)
    traces_first = disp.trace_count(PIPELINE_NAME) - t0

    # -- warm repeat: zero new traces ---------------------------------------
    t0 = disp.trace_count(PIPELINE_NAME)
    with disp.track_dispatch() as d_warm:
        warm = blocked_qr_sim(a, pipeline="on", fuse="auto", **kw)
    traces_second = disp.trace_count(PIPELINE_NAME) - t0

    # -- two-butterfly pipeline (fuse="off"): the pre-fusion baseline -------
    with disp.track_dispatch() as d_split, traffic.track_traffic() as t_split:
        split = blocked_qr_sim(a, pipeline="on", fuse="off", **kw)

    scale = float(eager.r.abs().max())

    # -- warn-gated wall clock: fused vs two-butterfly, both warm; on the
    # simulated comm the rounds saving is latency the simulation does not
    # model, so parity is expected — the hard-gated round counts carry the
    # claim.  Samples are interleaved so drift hits both schedules equally.
    def sample_us(fn):
        _sync(device)
        t = time.perf_counter()
        fn()
        _sync(device)
        return (time.perf_counter() - t) * 1e6

    fused_s, split_s = [], []
    for _ in range(max(1, repeats)):
        fused_s.append(sample_us(lambda: blocked_qr_sim(a, pipeline="on", fuse="auto", **kw)))
        split_s.append(sample_us(lambda: blocked_qr_sim(a, pipeline="on", fuse="off", **kw)))
    time_fused = float(np.percentile(fused_s, 50))
    time_split = float(np.percentile(split_s, 50))

    return {
        "p": p, "m_local": m_local, "n": n, "panel_width": panel_width,
        "n_panels": k_panels, "log2_p": log_p,
        "rounds_fused": t_fused.rounds_of("panel_reduce"),
        "rounds_split": t_split.rounds_of("panel_reduce"),
        "rounds_fused_expected": k_panels * log_p,
        "rounds_split_expected": (2 * k_panels - 1) * log_p,
        "overlapped_fused": t_fused.overlapped,
        "overlapped_split": t_split.overlapped,
        "wire_bytes_fused": t_fused.wire_bytes_of("panel_reduce"),
        "wire_bytes_split": t_split.wire_bytes_of("panel_reduce"),
        "traces_first": traces_first,
        "traces_second": traces_second,
        "dispatches_fused": d_cold.dispatches[PIPELINE_NAME],
        "dispatches_warm": d_warm.dispatches[PIPELINE_NAME],
        "dispatches_split": d_split.dispatches[PIPELINE_NAME],
        "stacked_wire_exact": _stacked_wire_exact(
            p, panel_width, max(n - panel_width, panel_width), device),
        "bit_identical_eager": (
            _bitwise(fused.r, eager.r) and _bitwise(fused.valid, eager.valid)
            and _bitwise(fused.q, eager.q)
        ),
        "bit_identical_split": _bitwise(fused.r, split.r) and _bitwise(fused.q, split.q),
        "bit_identical_warm": _bitwise(fused.r, warm.r) and _bitwise(fused.q, warm.q),
        "eager_rel_err": float((fused.r - eager.r).abs().max()) / scale,
        "valid_identical": _bitwise(fused.valid, eager.valid),
        "time_fused_p50_us": time_fused,
        "time_split_p50_us": time_split,
        "fused_speedup": time_split / max(time_fused, 1e-9),
    }


def case(p: int = 4, m_local: int = 160, n: int = 96, panel_width: int = 32,
         use_pallas: bool = True, device=None):
    rows = run(p=p, m_local=m_local, n=n, panel_width=panel_width,
               use_pallas=use_pallas, device=device)
    k, lg = rows["n_panels"], rows["log2_p"]
    if rows["rounds_fused"] != rows["rounds_fused_expected"]:
        raise BenchFailure(
            f"fused driver spent {rows['rounds_fused']} collective rounds on "
            f"panel reductions; one butterfly per panel demands exactly "
            f"K·log2 P = {k}·{lg} = {rows['rounds_fused_expected']}"
        )
    if rows["rounds_split"] != rows["rounds_split_expected"]:
        raise BenchFailure(
            f"two-butterfly driver spent {rows['rounds_split']} rounds; "
            f"expected (2K−1)·log2 P = {rows['rounds_split_expected']}"
        )
    if rows["wire_bytes_fused"] != rows["wire_bytes_split"]:
        raise BenchFailure(
            "fusion must conserve payload bytes (it halves rounds, not volume): "
            f"fused {rows['wire_bytes_fused']} B vs split {rows['wire_bytes_split']} B"
        )
    if not rows["stacked_wire_exact"]:
        raise BenchFailure(
            "engine-observed stacked wire bytes deviate from "
            "Plan.bytes_on_wire_stacked — the pricing model is wrong"
        )
    if rows["overlapped_fused"] != k - 1 or rows["overlapped_split"] != 0:
        raise BenchFailure(
            f"overlap accounting: fused {rows['overlapped_fused']} (expected "
            f"K−1 = {k - 1}), split {rows['overlapped_split']} (expected 0)"
        )
    if rows["eager_rel_err"] > EAGER_TOL or not rows["valid_identical"]:
        raise BenchFailure(
            "the fused pipeline deviates from the eager two-butterfly driver by "
            f"{rows['eager_rel_err']:.2e} rel (tolerance {EAGER_TOL:.0e}; valid "
            f"identical: {rows['valid_identical']})"
        )
    if not rows["bit_identical_warm"]:
        raise BenchFailure("a warm fused repeat changed the result bits")
    if rows["traces_second"] != 0:
        raise BenchFailure(
            f"{rows['traces_second']} new trace(s) on a repeat call — the fused "
            "pipeline broke the zero-retrace contract"
        )
    if rows["dispatches_fused"] != 1:
        raise BenchFailure(
            f"the fused pipeline ran {rows['dispatches_fused']} programs; fusion "
            "must not break the one-dispatch contract"
        )
    hard = dict(gate="hard", direction="exact")
    return {
        # THE claims: one butterfly per panel, payload conserved, overlap on
        "rounds_per_panel_fused": Metric(rows["rounds_fused"] // k, **hard),
        "rounds_fused": Metric(rows["rounds_fused"], **hard),
        "rounds_split": Metric(rows["rounds_split"], **hard),
        "wire_bytes_fused": Metric(rows["wire_bytes_fused"], **hard, unit="B"),
        "wire_bytes_conserved": Metric(
            rows["wire_bytes_fused"] == rows["wire_bytes_split"], **hard),
        "stacked_wire_exact": Metric(rows["stacked_wire_exact"], **hard),
        "overlapped_panels": Metric(rows["overlapped_fused"], **hard),
        "overlapped_split": Metric(rows["overlapped_split"], **hard),
        # the program model survives fusion
        "n_traces_total": Metric(rows["traces_first"] + rows["traces_second"], **hard),
        "n_traces_second_call": Metric(rows["traces_second"], **hard),
        "dispatches_per_call": Metric(rows["dispatches_fused"], **hard),
        "valid_identical": Metric(rows["valid_identical"], **hard),
        # bitwise recorded warn-gated, as the reference does
        "bit_identical_eager": Metric(rows["bit_identical_eager"], gate="warn",
                                      direction="exact"),
        "bit_identical_split": Metric(rows["bit_identical_split"], gate="warn",
                                      direction="exact"),
        "eager_rel_err": Metric(rows["eager_rel_err"], gate="warn", direction="lower"),
        # context + warn-gated wall clock
        "n_panels": Metric(rows["n_panels"], **hard),
        "time_fused_p50_us": Metric(rows["time_fused_p50_us"], gate="warn",
                                    direction="lower", unit="us"),
        "time_split_p50_us": Metric(rows["time_split_p50_us"], gate="warn",
                                    direction="lower", unit="us"),
        "fused_speedup": Metric(rows["fused_speedup"], gate="warn", direction="higher",
                                unit="x"),
    }


bench_case(
    "overlap",
    tags=("qr", "blocked", "comm", "fusion", "throughput"),
    params={
        "smoke": {"p": 4, "m_local": 160, "n": 96, "panel_width": 32},
        # the acceptance shape: 4096×512, panel width 128, 8 ranks
        "full": {"p": 8, "m_local": 512, "n": 512, "panel_width": 128},
    },
)(case)


def main(argv: list[str] | None = None) -> int:
    print("# fused stacked-payload panel reduction: rounds / bytes / overlap")
    for k, v in run().items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
