"""Paper Figs. 3-5 as a table: who holds the final R under each variant ×
failure scenario (the port of :mod:`repro.bench.cases.semantics`).  P=4
exactly as in the paper's walkthrough plus richer P=8 scenarios.  The case
gates on the worked example's holder counts and on the whole table's
holder total.  Host planning only: ``device`` is accepted and unused.
"""
from __future__ import annotations

from repro_torch.bench.registry import bench_case
from repro_torch.bench.schema import Metric
from repro_torch.collective import FaultSpec, make_plan

__all__ = ["SCENARIOS", "case", "run"]


SCENARIOS = [
    ("fault_free", 4, {}),
    ("fig3-5: P2 dies end of step 1", 4, {2: 1}),
    ("two deaths in tolerance", 8, {5: 1, 2: 2}),
    ("block wipe (beyond tolerance)", 8, {2: 1, 3: 1}),
    ("early death (step 0)", 8, {3: 0}),
]


def run():
    rows = []
    for name, p, deaths in SCENARIOS:
        spec = FaultSpec.of(deaths)
        for variant in ("tree", "redundant", "replace", "selfhealing"):
            plan = make_plan(variant, p, spec)
            holders = "".join("1" if v else "0" for v in plan.final_valid)
            rows.append({
                "scenario": name, "P": p, "variant": variant,
                "holders": holders, "n_holders": int(plan.final_valid.sum()),
            })
    return rows


def case(device=None):
    rows = run()
    hard = dict(gate="hard", direction="exact")
    fig = {r["variant"]: r["n_holders"] for r in rows if r["scenario"].startswith("fig3-5")}
    return {
        "n_scenarios": Metric(len(rows) // 4, **hard),
        # the paper's worked example: P=4, rank 2 dies at end of step 1
        "fig35_holders_redundant": Metric(fig["redundant"], **hard),
        "fig35_holders_replace": Metric(fig["replace"], **hard),
        "fig35_holders_selfhealing": Metric(fig["selfhealing"], **hard),
        # whole-table fingerprint: total holders across scenarios × variants
        "total_holders": Metric(sum(r["n_holders"] for r in rows), **hard),
    }


bench_case("semantics", tags=("robustness", "paper-figures"))(case)
