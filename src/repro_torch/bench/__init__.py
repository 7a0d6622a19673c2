"""Machine-readable benchmarks and fault scenarios on the port (the port of
:mod:`repro.bench`):

  * :mod:`.registry` — decorator-registered cases with tiers, tags and
    per-tier parameters;
  * :mod:`.runner` — warmup/repeat/percentile timing, writes versioned
    ``BENCH_<timestamp>.json`` documents under ``results/bench_torch/``;
  * :mod:`.schema` — the document schema and gate metadata (``hard``
    robustness/comm metrics vs ``warn`` timings);
  * :mod:`.compare` — the baseline comparator; exits non-zero on a
    hard-metric regression;
  * :mod:`.scenarios` — declarative fault schedules (collective, blocked
    QR, trainer);
  * :mod:`.cases` — the ported cases.

CLI: ``python -m repro_torch.bench run --tier smoke``, ``... compare old
new``, ``... list``.  This module imports neither torch nor the case
modules, so ``compare`` works in a bare environment.
"""
from .registry import REGISTRY, BenchFailure, SkipCase, bench_case, cases_for
from .schema import SCHEMA_VERSION, Metric, SchemaError, validate

__all__ = [
    "REGISTRY",
    "BenchFailure",
    "Metric",
    "SCHEMA_VERSION",
    "SchemaError",
    "SkipCase",
    "bench_case",
    "cases_for",
    "validate",
]
