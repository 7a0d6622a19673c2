"""Coded-redundancy frontier: overhead vs tolerated failures, hard-gated
(the port of :mod:`repro.bench.cases.coded`), on ``device`` (``None``: the
card).

  * **c deaths tolerated** — c Cauchy parity ranks survive c simultaneous
    step-0 deaths, every data rank ends valid, and the reconstructed R is
    within :func:`~repro_torch.collective.coded.reconstruction_tol` of the
    fault-free R;
  * **SDC detected** — an injected silent corruption is reconstructed from
    parity and flagged;
  * **wire bytes exact** — traffic observed through
    :class:`~repro_torch.collective.instrument.InstrumentedComm` equals
    ``CodedPlan.message_count()`` / ``bytes_on_wire()`` for the fault-free,
    death and corruption runs;
  * **overhead strictly below the butterfly** at equal tolerated-failure
    count;
  * **honest degradation** — c + 1 deaths give zero valid ranks and NaN
    payloads.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.registry import BenchFailure, bench_case
from repro_torch.bench.schema import Metric

__all__ = ["case", "run"]


def run(p: int = 8, m_local: int = 512, n: int = 512, parity: int = 3, seed: int = 0,
        device=None) -> dict:
    """Measure the coded scheme's guarantees and wire frontier; raw dict."""
    from repro_torch.collective import (
        FaultSpec,
        InstrumentedComm,
        SimComm,
        execute_coded,
        make_coded_plan,
        make_plan,
        reconstruction_tol,
        total_tolerance,
    )
    from repro_torch.collective.comm import resolve_device
    from repro_torch.qr import QRConfig, factorize

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((p, m_local, n)).astype(np.float32)
    a = torch.from_numpy(blocks).to(device)
    tol = reconstruction_tol(np.float32)

    ref = factorize(a, QRConfig(panel_width=None), device=device)
    r_ref = ref.r[0].cpu().numpy()
    scale = max(1.0, float(np.abs(r_ref).max()))

    dead = tuple(int(r) for r in rng.choice(p, size=parity, replace=False))
    cfg = QRConfig(panel_width=None, redundancy="coded", parity=parity)
    res_d = factorize(a, cfg, faults=FaultSpec.of({r: 0 for r in dead}), device=device)
    deaths_all_valid = bool(res_d.valid.cpu().numpy().all())
    death_err = float(np.abs(res_d.r[0].cpu().numpy() - r_ref).max() / scale)

    comb = QRConfig(panel_width=None).factorizer().combiner()

    def coded_run(spec, observed=None):
        comm = InstrumentedComm(SimComm(p + parity, device))
        plan = make_coded_plan(p, parity, spec)
        val, valid, det = execute_coded(a, comm, plan, comb, observed=observed)
        return plan, comm.stats, (val.cpu().numpy(), valid.cpu().numpy(), det.cpu().numpy())

    victim = int(rng.integers(p))
    observed = blocks.copy()
    observed[victim] *= 2.0                          # the silent corruption
    runs = {
        "fault_free": coded_run(None),
        "deaths": coded_run(FaultSpec.of({r: 0 for r in dead})),
        "corrupt": coded_run(FaultSpec.of(corrupt=(victim,)),
                             observed=torch.from_numpy(observed).to(device)),
    }
    wire_exact = all(
        stats.messages == plan.message_count() and stats.payload_bytes == plan.bytes_on_wire(n, 4)
        for plan, stats, _ in runs.values()
    )
    _, _, (val_c, valid_c, det_c) = runs["corrupt"]
    detected_exact = bool((np.flatnonzero(det_c[:p]) == np.array([victim])).all())
    corrupt_err = float(np.abs(val_c[0] - r_ref).max() / scale)
    corrupt_valid = bool(valid_c[:p].all())

    over = tuple(int(r) for r in range(parity + 1))
    _, _, (val_o, valid_o, _) = coded_run(FaultSpec.of({r: 0 for r in over}))
    honest = bool(not valid_o.any() and np.isnan(val_o).all())

    plan_ff = make_coded_plan(p, parity, None)
    bfly = make_plan("redundant", p)
    return {
        "p": p, "m_local": m_local, "n": n, "parity": parity,
        "deaths_all_valid": deaths_all_valid,
        "death_err": death_err,
        "reconstruction_tol": tol,
        "wire_exact": wire_exact,
        "detected_exact": detected_exact,
        "corrupt_err": corrupt_err,
        "corrupt_valid": corrupt_valid,
        "honest_degradation": honest,
        "tolerated_coded": parity,
        "tolerated_butterfly": total_tolerance("redundant", bfly.n_steps),
        "coded_payload_units": plan_ff.payload_units(),
        "butterfly_payload_units": bfly.message_count(),
        "coded_wire_bytes": plan_ff.bytes_on_wire(n, 4),
        "butterfly_wire_bytes": bfly.bytes_on_wire(n, 4),
    }


def case(p: int = 8, m_local: int = 512, n: int = 512, parity: int = 3, device=None):
    rows = run(p=p, m_local=m_local, n=n, parity=parity, device=device)
    if not rows["deaths_all_valid"] or rows["death_err"] > rows["reconstruction_tol"]:
        raise BenchFailure(
            f"{parity} parity ranks failed to tolerate {parity} simultaneous step-0 deaths "
            f"(all_valid={rows['deaths_all_valid']}, rel err {rows['death_err']:.2e} vs bound "
            f"{rows['reconstruction_tol']:.2e})"
        )
    if not rows["detected_exact"] or rows["corrupt_err"] > rows["reconstruction_tol"]:
        raise BenchFailure(
            "silent corruption was not detected-and-reconstructed "
            f"(detected_exact={rows['detected_exact']}, rel err {rows['corrupt_err']:.2e})"
        )
    if not rows["wire_exact"]:
        raise BenchFailure("observed wire traffic deviates from CodedPlan.bytes_on_wire / "
                           "message_count — the exact-accounting contract failed")
    if not rows["honest_degradation"]:
        raise BenchFailure(f"{parity + 1} deaths exceeded the erasure budget but did not "
                           "degrade honestly (expected zero valid ranks + NaN payloads)")
    if rows["tolerated_coded"] < rows["tolerated_butterfly"]:
        raise BenchFailure(f"frontier compared at unequal tolerance: coded tolerates "
                           f"{rows['tolerated_coded']}, butterfly {rows['tolerated_butterfly']}")
    if not rows["coded_payload_units"] < rows["butterfly_payload_units"]:
        raise BenchFailure(
            f"coded overhead ({rows['coded_payload_units']} payload units) is not strictly "
            f"below the butterfly's ({rows['butterfly_payload_units']}) at tolerance >= "
            f"{rows['tolerated_butterfly']}"
        )
    hard = dict(gate="hard", direction="exact")
    return {
        "deaths_all_valid": Metric(rows["deaths_all_valid"], **hard),
        "detected_exact": Metric(rows["detected_exact"], **hard),
        "corrupt_valid": Metric(rows["corrupt_valid"], **hard),
        "wire_exact": Metric(rows["wire_exact"], **hard),
        "honest_degradation": Metric(rows["honest_degradation"], **hard),
        "tolerated_coded": Metric(rows["tolerated_coded"], **hard),
        "tolerated_butterfly": Metric(rows["tolerated_butterfly"], **hard),
        "coded_payload_units": Metric(rows["coded_payload_units"], **hard),
        "butterfly_payload_units": Metric(rows["butterfly_payload_units"], **hard),
        "overhead_ratio": Metric(rows["coded_payload_units"] / rows["butterfly_payload_units"],
                                 gate="hard", direction="lower"),
        "coded_wire_bytes": Metric(rows["coded_wire_bytes"], **hard, unit="B"),
        "butterfly_wire_bytes": Metric(rows["butterfly_wire_bytes"], **hard, unit="B"),
        "death_err": Metric(rows["death_err"], gate="warn", direction="lower"),
        "corrupt_err": Metric(rows["corrupt_err"], gate="warn", direction="lower"),
    }


bench_case(
    "coded",
    tags=("robustness", "coded", "comm"),
    params={
        "smoke": {"p": 8, "m_local": 64, "n": 32, "parity": 3},
        "full": {"p": 8, "m_local": 512, "n": 512, "parity": 3},
    },
)(case)
