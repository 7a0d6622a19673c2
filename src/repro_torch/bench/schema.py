"""Versioned machine-readable benchmark document (``BENCH_<timestamp>.json``),
the port of :mod:`repro.bench.schema`.

Every run of ``python -m repro_torch.bench run`` writes one document (the
reference's, with ``torch_version`` in place of its framework version and
the card's ``nvidia-smi`` line under ``card``):

.. code-block:: json

    {
      "schema_version": 1,
      "created": "2026-07-27T12:34:56Z",
      "git_sha": "59d2844",            // null outside a git checkout
      "torch_version": "2.5.1",
      "backend": "cuda",               // "cuda" on the card, else "cpu"
      "card": "NVIDIA H100 80GB HBM3, 700.00 W",   // null without nvidia-smi
      "platform": "Linux-...",
      "python": "3.10.12",
      "n_devices": 8,
      "tier": "smoke",
      "cases": {
        "<case>": {
          "status": "ok" | "skipped" | "error",
          "params": {...},             // the tier's kwargs, as run
          "skip_reason": "...",        // skipped only
          "error": "...",              // error only
          "metrics": {
            "<metric>": {
              "value": 42,             // number or bool
              "gate": "hard" | "warn", // regression policy (see compare)
              "direction": "higher" | "lower" | "exact",
              "unit": "us",            // optional, informational
              "tolerance": 0.05        // optional per-metric rel. override
            }
          }
        }
      }
    }

Gate policy (enforced by :mod:`repro_torch.bench.compare`): ``hard`` metrics —
robustness counts, comm volume, tolerated-failure numbers — fail the
comparison on regression; ``warn`` metrics — wall-clock timings on shared
CI runners — only print a warning unless ``--strict-timing``.  Direction
``exact`` means the value is deterministic (message counts, survivor
counts, booleans) and must match the baseline (to within the float
tolerance for non-integral values).

The schema is validated on write and on compare, so a malformed producer
fails its own CI run rather than poisoning the baseline.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Any

__all__ = ["SCHEMA_VERSION", "Metric", "SchemaError", "metric_to_json", "validate"]

SCHEMA_VERSION = 1

_STATUSES = ("ok", "skipped", "error")
_GATES = ("hard", "warn")
_DIRECTIONS = ("higher", "lower", "exact")


class SchemaError(ValueError):
    """A benchmark document that does not conform to the schema."""


@dataclasses.dataclass(frozen=True)
class Metric:
    """One gated measurement.

    Bare numbers returned by a case are wrapped as informational
    ``Metric(value, gate="warn", direction="exact")`` by the runner; cases
    that want hard gating construct :class:`Metric` explicitly.
    """

    value: float | int | bool
    gate: str = "hard"          # "hard" | "warn"
    direction: str = "exact"    # "higher" | "lower" | "exact"
    unit: str = ""
    tolerance: float | None = None   # per-metric relative tolerance override

    def __post_init__(self):
        if self.gate not in _GATES:
            raise SchemaError(f"bad gate {self.gate!r}")
        if self.direction not in _DIRECTIONS:
            raise SchemaError(f"bad direction {self.direction!r}")


def metric_to_json(m: "Metric | float | int | bool") -> dict:
    if not isinstance(m, Metric):
        m = Metric(m, gate="warn", direction="exact")
    out: dict[str, Any] = {
        "value": bool(m.value) if isinstance(m.value, (bool,)) else m.value,
        "gate": m.gate,
        "direction": m.direction,
    }
    if m.unit:
        out["unit"] = m.unit
    if m.tolerance is not None:
        out["tolerance"] = float(m.tolerance)
    return out


def _fail(path: str, msg: str):
    raise SchemaError(f"{path}: {msg}")


def _check_metric(path: str, m: Any):
    if not isinstance(m, dict):
        _fail(path, "metric must be an object")
    v = m.get("value")
    if not isinstance(v, (bool, numbers.Real)):
        _fail(path, f"value must be a number or bool, got {type(v).__name__}")
    if m.get("gate") not in _GATES:
        _fail(path, f"gate must be one of {_GATES}, got {m.get('gate')!r}")
    if m.get("direction") not in _DIRECTIONS:
        _fail(path, f"direction must be one of {_DIRECTIONS}")
    tol = m.get("tolerance")
    if tol is not None and not (isinstance(tol, numbers.Real) and tol >= 0):
        _fail(path, "tolerance must be a non-negative number")
    extra = set(m) - {"value", "gate", "direction", "unit", "tolerance"}
    if extra:
        _fail(path, f"unknown metric keys {sorted(extra)}")


def validate(doc: dict) -> dict:
    """Validate ``doc`` against the schema; returns it unchanged."""
    if not isinstance(doc, dict):
        raise SchemaError("document must be an object")
    if doc.get("schema_version") != SCHEMA_VERSION:
        _fail("schema_version",
              f"expected {SCHEMA_VERSION}, got {doc.get('schema_version')!r}")
    for key in ("created", "torch_version", "backend", "tier"):
        if not isinstance(doc.get(key), str) or not doc[key]:
            _fail(key, "required non-empty string")
    if doc.get("git_sha") is not None and not isinstance(doc["git_sha"], str):
        _fail("git_sha", "must be a string or null")
    if not isinstance(doc.get("n_devices"), int) or doc["n_devices"] < 1:
        _fail("n_devices", "must be a positive int")
    cases = doc.get("cases")
    if not isinstance(cases, dict) or not cases:
        _fail("cases", "must be a non-empty object")
    for name, case in cases.items():
        path = f"cases.{name}"
        if not isinstance(case, dict):
            _fail(path, "case must be an object")
        status = case.get("status")
        if status not in _STATUSES:
            _fail(path, f"status must be one of {_STATUSES}, got {status!r}")
        if status == "skipped" and not case.get("skip_reason"):
            _fail(path, "skipped case needs a skip_reason")
        if status == "error" and not case.get("error"):
            _fail(path, "errored case needs an error message")
        metrics = case.get("metrics", {})
        if not isinstance(metrics, dict):
            _fail(path, "metrics must be an object")
        if status == "ok" and not metrics:
            _fail(path, "ok case must report at least one metric")
        for mname, m in metrics.items():
            _check_metric(f"{path}.metrics.{mname}", m)
    return doc
