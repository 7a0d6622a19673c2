"""The paper's own workload: fault-tolerant TSQR of tall-skinny matrices.

Not a neural architecture — these are the factorization workloads the
paper's tables/figures are built from, used by the benchmark harness and
the TSQR dry-run cells.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TSQRWorkload:
    name: str
    n_rows: int          # global m
    n_cols: int          # n (m >> n)
    variant: str
    dtype: str = "float32"


# One workload per paper scenario: the 4-process walkthroughs of Figs. 1-5
# scaled to the production mesh, plus the PowerSGD-shaped panels the
# optimizer layer factorizes every step.
WORKLOADS = {
    "paper_fig1": TSQRWorkload("paper_fig1", 1 << 20, 32, "tree"),
    "paper_fig2": TSQRWorkload("paper_fig2", 1 << 20, 32, "redundant"),
    "paper_fig4": TSQRWorkload("paper_fig4", 1 << 20, 32, "replace"),
    "paper_fig5": TSQRWorkload("paper_fig5", 1 << 20, 32, "selfhealing"),
    "powersgd_panel": TSQRWorkload("powersgd_panel", 1 << 22, 128, "redundant"),
    "wide_panel": TSQRWorkload("wide_panel", 1 << 21, 256, "redundant"),
}
