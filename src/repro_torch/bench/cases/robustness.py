"""Paper §III-B3/C3/D3 — survival probability vs failure count per variant
(the port of :mod:`repro.bench.cases.robustness`).

For each variant and each number of injected failures f, Monte-Carlo fault
placements (uniform over ranks × steps, numpy ``default_rng(seed)``, the
reference's draws) give the survival fraction and the within-tolerance
survival.  The case gates the largest failure count per variant for which
every within-tolerance placement survived, plus Self-Healing's theoretical
total tolerance; a guarantee violation raises
:class:`~repro_torch.bench.registry.BenchFailure`.  Host planning only:
``device`` is accepted and unused.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.registry import BenchFailure, bench_case
from repro_torch.bench.schema import Metric
from repro_torch.collective import FaultSpec, make_plan, total_tolerance, within_tolerance

__all__ = ["case", "run", "survival"]


def survival(variant: str, plan, death) -> bool:
    if variant == "tree":
        return bool(plan.final_valid[0])
    if variant == "redundant":
        return bool(plan.final_valid.any())
    if variant == "replace":
        alive = death >= (1 << 30)
        return bool((plan.final_valid | ~alive).all() and plan.final_valid.any())
    return bool(plan.final_valid.all())


def run(p: int = 16, trials: int = 400, seed: int = 0):
    rng = np.random.default_rng(seed)
    log_p = int(np.log2(p))
    rows = []
    for variant in ("tree", "redundant", "replace", "selfhealing"):
        for f in range(0, p):
            ok = 0
            ok_in_tol = tot_in_tol = 0
            for _ in range(trials):
                ranks = rng.choice(p, size=f, replace=False)
                steps = rng.integers(0, log_p, size=f)
                spec = FaultSpec.of({int(r): int(s) for r, s in zip(ranks, steps)})
                plan = make_plan(variant, p, spec)
                s = survival(variant, plan, spec.death_vector(p))
                ok += s
                if within_tolerance(variant, spec, log_p):
                    tot_in_tol += 1
                    ok_in_tol += s
            rows.append({
                "variant": variant, "failures": f,
                "survival_rate": ok / trials,
                "in_tolerance_rate": (ok_in_tol / tot_in_tol) if tot_in_tol else None,
            })
            if ok == 0 and f > p // 2:
                break
    return rows


def _guarantee_violations(rows) -> list[dict]:
    return [r for r in rows if r["in_tolerance_rate"] not in (None, 1.0)]


def case(p: int = 16, trials: int = 400, seed: int = 0, device=None):
    rows = run(p=p, trials=trials, seed=seed)
    bad = _guarantee_violations(rows)
    if bad:
        raise BenchFailure(
            "within-tolerance survival < 1.0 (the paper's guarantee broke): "
            + "; ".join(f"{r['variant']} f={r['failures']} rate={r['in_tolerance_rate']:.3f}"
                        for r in bad)
        )
    metrics = {"guarantee_holds": Metric(True, gate="hard", direction="exact")}
    for variant in ("tree", "redundant", "replace", "selfhealing"):
        guaranteed = [r["failures"] for r in rows
                      if r["variant"] == variant and r["in_tolerance_rate"] == 1.0]
        metrics[f"guaranteed_max_f_{variant}"] = Metric(
            max(guaranteed, default=0), gate="hard", direction="higher")
    metrics["selfhealing_total_tolerance"] = Metric(
        total_tolerance("selfhealing", int(np.log2(p))), gate="hard", direction="higher")
    return metrics


bench_case(
    "robustness",
    tags=("robustness", "monte-carlo"),
    params={
        "smoke": {"p": 16, "trials": 150, "seed": 0},
        "full": {"p": 16, "trials": 400, "seed": 0},
    },
)(case)
