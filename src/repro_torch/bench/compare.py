"""Baseline comparison and regression gating (the port of
:mod:`repro.bench.compare`).

``python -m repro_torch.bench compare baseline.json new.json [--tolerance 0.05]``
exits non-zero when a **hard**-gated metric regresses:

* the two documents are different tiers, or a case's parameters changed —
  the verdicts would be apples-to-oranges, so the comparison refuses and
  asks for a deliberate baseline refresh;
* a case present (and ``ok``) in the baseline is missing, skipped or
  errored in the new run — coverage regression;
* a hard metric disappears;
* a hard metric moves the wrong way past the tolerance:
  ``direction: higher`` → regression when ``new < old·(1−tol)``;
  ``direction: lower``  → regression when ``new > old·(1+tol)``;
  ``direction: exact``  → ints/bools must be equal, floats must agree to
  the relative tolerance.

Warn-gated metrics (timings on shared runners) use ``--timing-tolerance``
and only print warnings, unless ``--strict-timing`` promotes them.  A
per-metric ``tolerance`` recorded in the document overrides the CLI value.
Improvements and metrics new in the new run are reported as notes.
"""
from __future__ import annotations

import dataclasses
import json
import math

from . import schema

__all__ = ["Comparison", "compare_docs", "compare_files", "load"]


@dataclasses.dataclass
class Comparison:
    failures: list[str] = dataclasses.field(default_factory=list)
    warnings: list[str] = dataclasses.field(default_factory=list)
    notes: list[str] = dataclasses.field(default_factory=list)

    def exit_code(self, strict_timing: bool = False) -> int:
        if self.failures:
            return 1
        if strict_timing and self.warnings:
            return 1
        return 0

    def report(self) -> str:
        lines = []
        for f in self.failures:
            lines.append(f"FAIL  {f}")
        for w in self.warnings:
            lines.append(f"WARN  {w}")
        for n in self.notes:
            lines.append(f"note  {n}")
        if not self.failures:
            lines.append(
                "OK    no hard regressions"
                + (f" ({len(self.warnings)} warning(s))" if self.warnings else "")
            )
        return "\n".join(lines)


def load(path: str) -> dict:
    with open(path) as f:
        return schema.validate(json.load(f))


def _is_exact_kind(v) -> bool:
    return isinstance(v, bool) or (
        isinstance(v, (int, float)) and float(v).is_integer()
    )


def _regressed(old, new, direction: str, tol: float) -> bool:
    if isinstance(old, bool) or isinstance(new, bool):
        return bool(old) != bool(new)
    old, new = float(old), float(new)
    if not math.isfinite(new):
        return True
    scale = max(abs(old), 1e-12)
    if direction == "higher":
        return new < old - tol * scale
    if direction == "lower":
        return new > old + tol * scale
    # exact: integral values must match exactly; floats to tolerance
    if _is_exact_kind(old) and _is_exact_kind(new):
        return old != new
    return abs(new - old) > tol * scale


def compare_docs(
    old: dict,
    new: dict,
    *,
    tolerance: float = 0.05,
    timing_tolerance: float = 0.50,
) -> Comparison:
    cmp = Comparison()
    if old.get("torch_version") != new.get("torch_version"):
        cmp.notes.append(
            f"torch {old.get('torch_version')} → {new.get('torch_version')}"
        )
    if old.get("tier") != new.get("tier"):
        # different tiers run different parameters: every hard verdict
        # below would be apples-to-oranges, so refuse up front
        cmp.failures.append(
            f"tier mismatch: baseline is {old.get('tier')!r}, new run is "
            f"{new.get('tier')!r} — compare runs of the same tier"
        )
        return cmp
    for cname, ocase in old["cases"].items():
        ncase = new["cases"].get(cname)
        path = f"case {cname}"
        if ncase is None:
            if ocase["status"] == "ok":
                cmp.failures.append(f"{path}: present in baseline, missing now")
            else:
                cmp.notes.append(f"{path}: non-ok in baseline, missing now")
            continue
        if ocase["status"] != "ok":
            if ocase["status"] == "skipped" and ncase["status"] == "ok":
                cmp.notes.append(f"{path}: newly running (was skipped)")
            continue
        if ncase["status"] != "ok":
            detail = ncase.get("skip_reason") or ncase.get("error") or ""
            cmp.failures.append(
                f"{path}: was ok, now {ncase['status']} ({detail})"
            )
            continue
        if ocase.get("params") != ncase.get("params"):
            # metrics were measured under different knobs — a stale
            # baseline, not a regression; demand a deliberate refresh
            cmp.failures.append(
                f"{path}: params changed {ocase.get('params')} → "
                f"{ncase.get('params')} — refresh benchmarks/baseline.json"
            )
            continue
        ometrics, nmetrics = ocase.get("metrics", {}), ncase.get("metrics", {})
        for mname, om in ometrics.items():
            mpath = f"{cname}.{mname}"
            nm = nmetrics.get(mname)
            hard = om["gate"] == "hard"
            if nm is None:
                (cmp.failures if hard else cmp.warnings).append(
                    f"{mpath}: metric missing"
                )
                continue
            tol = om.get("tolerance")
            if tol is None:
                tol = tolerance if hard else timing_tolerance
            if _regressed(om["value"], nm["value"], om["direction"], tol):
                msg = (f"{mpath}: {om['value']} → {nm['value']} "
                       f"(direction={om['direction']}, tol={tol:g})")
                (cmp.failures if hard else cmp.warnings).append(msg)
        for mname in nmetrics.keys() - ometrics.keys():
            cmp.notes.append(f"{cname}.{mname}: new metric")
    for cname in new["cases"].keys() - old["cases"].keys():
        cmp.notes.append(f"case {cname}: new case (no baseline)")
    return cmp


def compare_files(old_path: str, new_path: str, **kw) -> Comparison:
    return compare_docs(load(old_path), load(new_path), **kw)
