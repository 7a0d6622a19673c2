"""General-matrix blocked QR — numerics, guarantees, device-memory model;
hard-gated (the port of :mod:`repro.bench.cases.general_qr`), on ``device``
(``None``: the card; the Hopper kernels there with ``use_pallas``, their
plain versions on the CPU).

The panel-pipeline claim is a *number*: the right-looking blocked QR touches
the trailing block exactly **once per panel** — the prime cross-product
sweep plus one fused update sweep per non-final panel, each panel's Gram
and cross products arriving from the previous update's lookahead
accumulator.  The case measures that with the traffic records of
:mod:`repro_torch.kernels.traffic` and hard-gates:

  * ``trailing_sweeps`` == ``n_panels`` and ``sweeps_per_panel`` == 1;
  * the exact trailing-path read/write byte totals (deterministic functions
    of the shape — ``direction: exact``);
  * numerical safety: R must match the dense float64 oracle
    (:mod:`repro_torch.core.ref`) to f32 tolerance and Q must reconstruct
    A — violations raise :class:`~repro_torch.bench.registry.BenchFailure`;
  * the per-variant failure guarantee: a within-tolerance death schedule
    injected mid-factorization leaves the host-predicted survivor count,
    every survivor holding the exact R;
  * the single-program discipline: the fault-free factorization runs exactly
    **one** cached program, and the B-matrix batched shape runs one program
    for the whole batch with every element matching the dense oracle.

Wall-clock timings ride along warn-gated.  The full tier runs the
acceptance shape: 4096×512 at panel width 128.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.registry import BenchFailure, bench_case
from repro_torch.bench.schema import Metric

__all__ = ["GUARANTEE_SPECS", "R_TOL", "case", "main", "run"]

R_TOL = 5e-4              # f32 tolerance vs the f64 dense oracle

GUARANTEE_SPECS = {
    # one death at entry of exchange 1 — within tolerance for every
    # redundant variant at any power-of-two p ≥ 2
    "redundant": {1: 1},
    "replace": {1: 1},
    "selfhealing": {1: 1},
}

TRAILING_OPS = ("panel_cross", "pad_cross", "trailing_update")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def run(p: int = 4, m_local: int = 128, n: int = 96, panel_width: int = 32,
        use_pallas: bool = True, batch: int = 8, device=None) -> dict:
    """Execute the blocked QR under the traffic tracker; return the model
    numbers and numerical measurements."""
    from repro_torch.collective import FaultSpec, within_tolerance
    from repro_torch.collective.comm import resolve_device
    from repro_torch.core import ref
    from repro_torch.kernels import dispatch as disp
    from repro_torch.kernels import traffic
    from repro_torch.qr import PanelFaultSchedule, blocked_qr_batched, blocked_qr_sim
    from repro_torch.qr.blocked import PIPELINE_NAME

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((p, m_local, n)).astype(np.float32)
    truth = ref.qr_r(blocks.reshape(-1, n).astype(np.float64))
    scale = np.abs(truth).max()

    with traffic.track_traffic() as t:
        res = blocked_qr_sim(blocks, panel_width=panel_width, compute_q=True,
                             use_pallas=use_pallas, device=device)
    r = _np(res.r)
    r_err = float(np.abs(r[0] - truth).max() / scale)
    q = _np(res.q).reshape(-1, n)
    recon_err = float(np.abs(q @ r[0] - blocks.reshape(-1, n)).max() / scale)
    ortho_err = float(np.abs(q.T @ q - np.eye(n)).max())
    trailing = [rec for rec in t.records if rec["op"] in TRAILING_OPS]

    # -- batched throughput shape: B independent user matrices, one program
    ab = rng.standard_normal((batch, p, m_local, n)).astype(np.float32)
    ab[0] = blocks
    with disp.track_dispatch() as d:
        bres = blocked_qr_batched(ab, panel_width=panel_width, use_pallas=use_pallas,
                                  device=device)
    batched_dispatches = int(d.dispatches[PIPELINE_NAME])
    batched_err = float(np.abs(_np(bres.r[0, 0]) - truth).max() / scale)
    del bres

    # -- per-variant guarantee: within-tolerance deaths mid-factorization --
    mid_panel = res.n_panels // 2
    survivors = {}
    for variant, deaths in GUARANTEE_SPECS.items():
        spec = FaultSpec.of(deaths)
        n_steps = res.reports[0].plan_r.n_steps
        if not within_tolerance(variant, spec, n_steps):
            raise BenchFailure(
                f"{variant}: guarantee spec {deaths} is outside tolerance "
                f"at p={p} — the case's precondition is broken"
            )
        fres = blocked_qr_sim(
            blocks, panel_width=panel_width, variant=variant,
            faults=PanelFaultSchedule.of(panel={mid_panel: spec}),
            use_pallas=use_pallas, device=device,
        )
        valid = _np(fres.valid)
        fr = _np(fres.r)
        ok = bool(valid.size) and all(
            np.abs(fr[i] - truth).max() / scale < R_TOL for i in np.flatnonzero(valid)
        )
        survivors[variant] = {
            "survivors": int(valid.sum()),
            "match": ok,
            "expected": int(fres.reports[mid_panel].plan_r.final_valid.sum()),
        }
    return {
        "p": p, "m_local": m_local, "n": n, "panel_width": panel_width,
        "n_panels": res.n_panels,
        "trailing_sweeps": t.sweeps_of(*TRAILING_OPS),
        "trailing_read_bytes": sum(rec["read_bytes"] for rec in trailing),
        "trailing_write_bytes": sum(rec["write_bytes"] for rec in trailing),
        "dispatches": t.dispatches,
        "r_err": r_err,
        "recon_err": recon_err,
        "ortho_err": ortho_err,
        "batch": batch,
        "batched_dispatches": batched_dispatches,
        "batched_r_err": batched_err,
        "survivors": survivors,
    }


def case(p: int = 4, m_local: int = 128, n: int = 96, panel_width: int = 32,
         use_pallas: bool = True, batch: int = 8, device=None):
    rows = run(p=p, m_local=m_local, n=n, panel_width=panel_width,
               use_pallas=use_pallas, batch=batch, device=device)
    if rows["r_err"] > R_TOL:
        raise BenchFailure(
            f"blocked R deviates from the dense QR by {rows['r_err']:.2e} "
            f"(tolerance {R_TOL:.0e})"
        )
    if rows["recon_err"] > R_TOL:
        raise BenchFailure(
            f"Q·R reconstruction error {rows['recon_err']:.2e} exceeds {R_TOL:.0e}"
        )
    if rows["trailing_sweeps"] != rows["n_panels"]:
        raise BenchFailure(
            f"{rows['trailing_sweeps']} trailing-block sweeps for "
            f"{rows['n_panels']} panels — the 1-sweep-per-panel claim failed"
        )
    if rows["dispatches"] != 1:
        raise BenchFailure(
            f"the fault-free factorization ran {rows['dispatches']} "
            "programs — the single-dispatch pipeline claim failed"
        )
    if rows["batched_dispatches"] != 1:
        raise BenchFailure(
            f"the B={rows['batch']} batched factorization ran "
            f"{rows['batched_dispatches']} programs instead of 1"
        )
    if rows["batched_r_err"] > R_TOL:
        raise BenchFailure(
            f"batched R deviates from the dense QR by "
            f"{rows['batched_r_err']:.2e} (tolerance {R_TOL:.0e})"
        )
    hard = dict(gate="hard", direction="exact")
    metrics = {
        # THE claim: trailing block touched once per panel, bytes exact,
        # the whole fault-free factorization one program
        "n_panels": Metric(rows["n_panels"], **hard),
        "trailing_sweeps": Metric(rows["trailing_sweeps"], **hard),
        "sweeps_per_panel": Metric(rows["trailing_sweeps"] / rows["n_panels"], **hard),
        "trailing_read_bytes": Metric(rows["trailing_read_bytes"], **hard, unit="B"),
        "trailing_write_bytes": Metric(rows["trailing_write_bytes"], **hard, unit="B"),
        "dispatches": Metric(rows["dispatches"], **hard),
        "batched_b": Metric(rows["batch"], **hard),
        "batched_dispatches": Metric(rows["batched_dispatches"], **hard),
        "batched_r_err": Metric(rows["batched_r_err"], gate="warn", direction="lower"),
        # enforced above through BenchFailure; recorded values only warn on
        # drift
        "r_err": Metric(rows["r_err"], gate="warn", direction="lower"),
        "recon_err": Metric(rows["recon_err"], gate="warn", direction="lower"),
        "ortho_err": Metric(rows["ortho_err"], gate="warn", direction="lower"),
    }
    for variant, s in rows["survivors"].items():
        if not s["match"]:
            raise BenchFailure(
                f"{variant}: within-tolerance deaths but a survivor's R "
                "does not match the dense QR"
            )
        if s["survivors"] != s["expected"]:
            raise BenchFailure(
                f"{variant}: {s['survivors']} survivors, host plan predicts {s['expected']}"
            )
        metrics[f"survivors_{variant}"] = Metric(s["survivors"], **hard)
    return metrics


bench_case(
    "general_qr",
    tags=("qr", "blocked", "robustness", "hbm"),
    params={
        "smoke": {"p": 4, "m_local": 128, "n": 96, "panel_width": 32},
        # the acceptance shape: 4096×512, panel width 128, 8 ranks
        "full": {"p": 8, "m_local": 512, "n": 512, "panel_width": 128},
    },
)(case)


def main(device=None):
    print("# blocked QR: trailing-block sweeps (1 per panel) + survival")
    print("p,m_local,n,panel_width,n_panels,trailing_sweeps,r_err,recon_err")
    out = []
    for kw in ({"p": 4, "m_local": 128, "n": 96, "panel_width": 32},
               {"p": 8, "m_local": 512, "n": 512, "panel_width": 128, "use_pallas": False}):
        rows = run(**kw, device=device)
        print(f"{rows['p']},{rows['m_local']},{rows['n']},{rows['panel_width']},"
              f"{rows['n_panels']},{rows['trailing_sweeps']},{rows['r_err']:.2e},"
              f"{rows['recon_err']:.2e}")
        out.append(rows)
    return out


if __name__ == "__main__":
    main()
