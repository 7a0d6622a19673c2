"""Roofline-seeded autotuner for the Hopper kernels' row splits (the port of
:mod:`repro.kernels.autotune`).

The one run-time knob of the port's kernels is the **row split**: how many
rows each CTA of a Gram or cross-product launch sums before the splits are
folded (``_launch.row_split`` / ``cross_split``).  Untuned, the split is a
fixed function of the shape (four CTAs an SM for the Gram kernels, two for
the cross kernels).  This module searches it per ``(kernel, backend, dtype,
shape class)``:

  * ``block_rows`` — rows per split, a multiple of the 32-row streamed
    chunk, clamped to ``m`` rounded up to 32;
  * ``accum_budget_bytes`` — the f32 partial buffer one launch may
    allocate (``batch × splits × out_rows × out_cols × 4``); a candidate
    whose partials overflow it, or whose splits overflow a launch's grid
    (65 535), is *illegal*, not merely slow;
  * ``gemm_width_floor`` — computed as in the reference (the narrow-dot
    padding width its XLA route keeps), but it has **no consumer** in the
    port: the plain route pads no dots;
  * ``fuse_want_q`` — whether the fused apply+Gram sweep beats the unfused
    pair for the class, on the prior.

``apply_right`` sums no rows across CTAs and its row tile is a template
constant of ``csrc/apply_right.cu`` (256, 512 or 1024 rows by width): it
cannot take a row count at run time without a new build, so its entry has
the fixed tiling as its one legal candidate (``apply_right.fixed_rows``).

**Shared splits.**  Kernels tied by a bitwise contract resolve one split:
``fused_apply_gram`` takes the ``gram`` entry's winner (``gram(q)`` ≡ its
G'), and ``panel_cross`` / ``pad_cross`` take the ``trailing_update``
entry's (S ≡ ``panel_cross(A_new)``, pipeline ≡ eager).  :func:`tune`
picks ``gram``'s winner on the pair's summed time and writes the same
``block_rows`` and measured candidates into both entries, so
:func:`select_winner` re-picks it in each.

The search is **roofline-seeded**: :func:`predict` prices each candidate as
``max(streamed_bytes / bandwidth, flops / peak)`` divided by the launch's
fill (a launch with fewer CTAs than four per SM leaves the memory system
under-fed), plus a fixed cost per wave of CTAs.  Streamed bytes are the
operands over the rows padded to the 32-row chunk, plus the per-split f32
partials each Gram or cross launch writes and its fold reads back (the
reference's ``gpu-triton`` branch).  Only the top few candidates and the
untuned split are measured.  The machine constants come from two probes on
the device: a device-to-device copy and an f32 product with TF32 off,
timed with CUDA events (an injectable clock replaces them in tests).

Winners persist as schema-versioned JSON under ``results/autotune/<kind>
.json`` (never the reference's file) with an in-process cache that the
``ops`` wrappers and the blocked QR consult.  A tuned ``block_rows`` is
resolved to a concrete int at the Python level before it keys a cached
program, so installing a table re-records only the affected shape classes.
Entries keep the reference's fields and add ``batch``, the leading batch
the entry was measured at.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from . import _launch
from . import dispatch as _dispatch
from . import traffic as _traffic
from .apply_right import fixed_rows
from .backend import DEFAULT_BLOCK_ROWS, KINDS, SUBLANE, Backend, pick_block_rows, resolve_backend

__all__ = [
    "ACCUM_BUDGET_BYTES",
    "AutotuneError",
    "AutotuneSchemaError",
    "DEFAULT_KERNELS",
    "DEFAULT_OUT_DIR",
    "MIN_GEMM_FLOOR",
    "MachineModel",
    "Prediction",
    "SHARED_SPLIT",
    "candidate_block_rows",
    "clear",
    "committed_traffic",
    "default_block_rows",
    "entry_key",
    "entry_legal",
    "generation",
    "install",
    "installed",
    "load_table",
    "lookup",
    "machine_constants",
    "main",
    "measure_machine",
    "predict",
    "resolve_block_rows",
    "save_table",
    "select_winner",
    "shape_class",
    "trailing_panel_width",
    "tune",
    "tune_kernel",
    "validate_table",
]

SCHEMA_VERSION = 1
DEFAULT_OUT_DIR = os.path.join("results", "autotune")
DEFAULT_KERNELS = ("gram", "apply_right", "fused_apply_gram", "trailing_update")

# The entry whose winner each kernel takes: kernels tied by a bitwise
# contract must sum the same rows per split.
SHARED_SPLIT = {"fused_apply_gram": "gram", "panel_cross": "trailing_update",
                "pad_cross": "trailing_update"}

MIN_GEMM_FLOOR = 4
_GEMM_FLOOR_CANDIDATES = (4, 8)

# The f32 partial buffer one launch may allocate (bytes).  The plain route
# has no split and allocates none.
ACCUM_BUDGET_BYTES = {"cuda": 256 << 20, "plain": 256 << 20}

_BASE_BLOCK_ROWS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
_GRAM_KERNELS = ("gram", "fused_apply_gram")


class AutotuneError(ValueError):
    """An invalid tuning request or corrupt tuned table."""


class AutotuneSchemaError(AutotuneError):
    """A persisted table that does not conform to the schema (stale
    ``schema_version``, missing fields): rejected, never half-loaded."""


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Measured machine constants the roofline prior prices against.
    ``step_overhead_s`` is the fixed cost of one wave of CTAs (their
    prologue and epilogue), not measured."""

    mem_bw_bytes_per_s: float
    flops_per_s: float
    step_overhead_s: float = 2e-6

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Prediction:
    """The analytic model of one (kernel, shape, batch, split) launch.

    ``read_bytes``/``write_bytes`` are the committed operand bytes of the
    batch, what the ``ops`` wrappers note to :mod:`.traffic`.
    ``streamed_bytes`` adds the 32-row edge padding and the partials' round
    trip; ``accum_bytes`` is the partial buffer, ``grid_steps`` the splits."""

    read_bytes: int
    write_bytes: int
    dispatches: int
    streamed_bytes: int
    flops: float
    accum_bytes: int
    grid_steps: int
    seconds: float


# ---------------------------------------------------------------------------
# shape classes and keys (identical to the reference's)
# ---------------------------------------------------------------------------

def shape_class(m: int, n: int) -> str:
    """Bucket ``m`` to the next power of two; ``n`` stays exact."""
    p2 = 1 << max(int(m) - 1, 0).bit_length()
    return f"m{p2}xn{int(n)}"


def entry_key(kernel: str, backend_kind: str, dtype, klass: str) -> str:
    return f"{kernel}|{backend_kind}|{_dtype_name(dtype)}|{klass}"


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):       # numpy has no bfloat16 of its own
        return dtype
    return np.dtype(dtype).name


def _itemsize(dtype) -> int:
    return {"float32": 4, "bfloat16": 2}[_dtype_name(dtype)]


def trailing_panel_width(n: int) -> int:
    """The representative blocked-QR panel width for an n-wide trailing
    block: what ``trailing_update`` tuning factors the shape with."""
    return min(int(n), max(MIN_GEMM_FLOOR, int(n) // 4))


# ---------------------------------------------------------------------------
# the analytic model
# ---------------------------------------------------------------------------

def committed_traffic(kernel: str, m: int, n: int, dtype,
                      *, want_q: bool = True) -> tuple[int, int, int]:
    """(read_bytes, write_bytes, dispatches) of one (m, n) matrix exactly as
    the ``ops`` wrappers note them: operand bytes, split independent."""
    it = _itemsize(dtype)
    if kernel == "gram":
        return m * n * it, n * n * 4, 1
    if kernel == "apply_right":
        return m * n * it + n * n * it, m * n * it, 1
    if kernel == "fused_apply_gram":
        w = m * n * it if want_q else 0
        return m * n * it + n * n * it, w + n * n * 4, 1
    if kernel == "trailing_update":
        b = trailing_panel_width(n)
        read = m * n * it + m * b * it + b * n * it
        return read, m * n * it + b * n * 4, 1
    raise AutotuneError(f"unknown kernel {kernel!r} (expected one of {DEFAULT_KERNELS})")


def _pairs(width: int) -> int:
    """Upper-triangle tile pairs of a width-``width`` Gram (one CTA each)."""
    tile = 32 if width <= 32 else (64 if width <= 64 else 128)
    nt = -(-width // tile)
    return nt * (nt + 1) // 2


def default_block_rows(kernel: str, m: int, n: int, *, batch: int = 1) -> int:
    """The untuned split the kernel takes at this shape and batch (for
    ``apply_right``, its fixed tile)."""
    if kernel in _GRAM_KERNELS:
        return _launch.row_split(batch, m, n)[0]
    if kernel == "apply_right":
        return pick_block_rows(m, fixed_rows(n, n))
    if kernel in ("trailing_update", "panel_cross", "pad_cross"):
        return _launch.cross_split(batch, m)[0]
    raise AutotuneError(f"unknown kernel {kernel!r}")


def predict(kernel: str, m: int, n: int, dtype, *, block_rows: int,
            machine: MachineModel, backend: Backend, want_q: bool = True,
            gemm_floor: int = MIN_GEMM_FLOOR, batch: int = 1) -> Prediction:
    """Roofline prior for one candidate (see :class:`Prediction`)."""
    it = _itemsize(dtype)
    br = pick_block_rows(m, block_rows, sublane=backend.sublane)
    g = math.ceil(m / br)                        # splits
    rows = -(-m // SUBLANE) * SUBLANE            # rows incl. the chunk's edge padding
    cuda = backend.kind == "cuda"
    read, write, dispatches = committed_traffic(kernel, m, n, dtype, want_q=want_q)

    def partials(rows_out: int, cols_out: int) -> int:
        # per-split f32 partials: written by the kernel, read by the fold
        return g * rows_out * cols_out * 4 if cuda else 0

    if kernel == "gram":
        accum = partials(n, n)
        streamed = rows * n * it + n * n * 4 + 2 * accum
        flops = 2.0 * rows * n * n
        ctas = _pairs(n) * g
    elif kernel == "apply_right":
        accum = 0
        streamed = rows * n * it + n * n * it + rows * n * it
        flops = 2.0 * rows * n * n
        ctas = g * -(-n // 128)
    elif kernel == "fused_apply_gram":
        accum = partials(n, n)
        streamed = (rows * n * it + n * n * it + n * n * 4
                    + (rows * n * it if want_q else 0) + 2 * accum)
        flops = 4.0 * rows * n * n
        ctas = _pairs(n) * g
    else:  # trailing_update
        b = trailing_panel_width(n)
        b_eff = max(b, gemm_floor)               # the reference's narrow-dot floor
        accum = partials(b, n)
        streamed = (rows * (n + b) * it + b * n * it + rows * n * it + b * n * 4 + 2 * accum)
        flops = 2.0 * rows * n * (b_eff + b)
        ctas = g * -(-n // 128)
    ctas *= batch
    fill = min(1.0, ctas / _launch._TARGET_CTAS) if cuda else 1.0
    seconds = max(batch * streamed / machine.mem_bw_bytes_per_s,
                  batch * flops / machine.flops_per_s) / fill
    seconds += math.ceil(ctas / _launch._TARGET_CTAS) * machine.step_overhead_s
    return Prediction(
        read_bytes=batch * read, write_bytes=batch * write, dispatches=dispatches,
        streamed_bytes=int(batch * streamed), flops=float(batch * flops),
        accum_bytes=int(batch * accum), grid_steps=g, seconds=float(seconds),
    )


def candidate_block_rows(m: int, backend: Backend, *, kernel: str = "gram", n: int = 1,
                         batch: int = 1) -> tuple[int, ...]:
    """Splits to consider, clamped to the shape: the base heights, the
    reference's default and the kernel's untuned split.  ``apply_right``
    has its fixed tile only."""
    if kernel == "apply_right":
        return (default_block_rows(kernel, m, n),)
    base = set(_BASE_BLOCK_ROWS) | {backend.sublane, DEFAULT_BLOCK_ROWS,
                                    default_block_rows(kernel, m, n, batch=batch)}
    return tuple(sorted({pick_block_rows(m, c, sublane=backend.sublane)
                         for c in base if c >= backend.sublane}))


# ---------------------------------------------------------------------------
# machine probes
# ---------------------------------------------------------------------------

def _p50(fn, timer, reps: int, device: torch.device) -> float:
    """Median seconds of ``reps`` calls after one warm call.  ``timer`` is
    a clock read around each call with a synchronize inside it; without
    one, CUDA events on the card and ``perf_counter`` on the CPU."""
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    fn()
    sync()
    samples = []
    for _ in range(max(1, reps)):
        if timer is None and cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
            continue
        clock = timer or time.perf_counter
        t0 = clock()
        fn()
        sync()
        samples.append(clock() - t0)
    return float(np.median(samples))


def measure_machine(*, timer=None, reps: int = 3, device=None) -> MachineModel:
    """Measure the two roofline denominators on ``device``: a
    device-to-device copy (read + write bytes) and a square f32 product
    with TF32 off.  ``timer`` is injectable (tests pass a scripted clock)."""
    dev = resolve_backend(device).device
    cuda = dev.type == "cuda"
    n_copy = (1 << 26) if cuda else (1 << 22)        # 256 MiB on the card, 16 MiB here
    k = 4096 if cuda else 384
    x = torch.ones(n_copy, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    a = torch.ones((k, k), dtype=torch.float32, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with _traffic.suppress(), _dispatch.suppress():
            t_copy = max(_p50(lambda: y.copy_(x), timer, reps, dev), 1e-9)
            t_mm = max(_p50(lambda: a @ a, timer, reps, dev), 1e-9)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return MachineModel(mem_bw_bytes_per_s=2.0 * n_copy * 4 / t_copy,
                        flops_per_s=2.0 * k ** 3 / t_mm)


# ---------------------------------------------------------------------------
# the measured search
# ---------------------------------------------------------------------------

def _kernel_runner(kernel: str, m: int, n: int, dtype, backend: Backend, batch: int = 1):
    """Build ``fn(block_rows)`` running one launch of the kernel at the
    class's representative shape and batch, on the backend's device, its
    operands drawn there from a seeded ``torch.Generator``."""
    from . import apply_right as _apply_mod
    from . import fused_apply_gram as _fused_mod
    from . import gram as _gram_mod
    from . import trailing_update as _trailing_mod

    gen = torch.Generator(device=backend.device)
    gen.manual_seed(0)
    dt = getattr(torch, _dtype_name(dtype))
    lead = (batch,) if batch > 1 else ()

    def tensor(*shape, scale=1.0):
        x = torch.randn(lead + shape, generator=gen, device=backend.device) * scale
        return x.to(dt)

    a = tensor(m, n)
    if kernel == "gram":
        return lambda br: _gram_mod.gram(a, block_rows=br)
    if kernel == "apply_right":
        w = tensor(n, n, scale=1.0 / n)
        return lambda br: _apply_mod.apply_right(a, w, block_rows=br)
    if kernel == "fused_apply_gram":
        w = tensor(n, n, scale=1.0 / n)
        return lambda br: _fused_mod.fused_apply_gram(a, w, block_rows=br)
    b = trailing_panel_width(n)
    q = tensor(m, b)
    w = tensor(b, n, scale=1.0 / n)
    return lambda br: _trailing_mod.trailing_update(a, q, w, next_width=b, block_rows=br)


def _search(kernels: tuple[str, ...], m: int, n: int, dtype, backend: Backend,
            machine: MachineModel, timer, reps: int, measure_top: int, batch: int):
    """Rank the candidates every kernel of ``kernels`` may take by their
    summed prior, measure the top ``measure_top`` and the untuned split,
    and pick the least summed time (ties to the smaller split).  Returns
    ``(legal, predictions by kernel, measured, winner)``."""
    budget = ACCUM_BUDGET_BYTES[backend.kind]
    cands = candidate_block_rows(m, backend, kernel=kernels[0], n=n, batch=batch)
    preds = {k: {c: predict(k, m, n, dtype, block_rows=c, machine=machine, backend=backend,
                            batch=batch) for c in cands} for k in kernels}
    legal = [c for c in cands
             if all(preds[k][c].accum_bytes <= budget and preds[k][c].grid_steps
                    <= _launch.MAX_SPLITS for k in kernels)]
    if not legal:                          # budget smaller than any candidate
        legal = [min(cands, key=lambda c: max(preds[k][c].accum_bytes for k in kernels))]
    ranked = sorted(legal, key=lambda c: (sum(preds[k][c].seconds for k in kernels), c))
    to_measure = list(ranked[:max(1, measure_top)])
    default = default_block_rows(kernels[0], m, n, batch=batch)
    if default in legal and default not in to_measure:
        to_measure.append(default)
    runs = [_kernel_runner(k, m, n, dtype, backend, batch) for k in kernels]
    measured: dict[int, float] = {}
    with _traffic.suppress(), _dispatch.suppress():
        for c in to_measure:
            measured[c] = sum(_p50(lambda: run(c), timer, reps, backend.device) for run in runs)
    winner = min(measured, key=lambda c: (measured[c], c))
    return legal, preds, measured, winner


def _entry(kernel: str, m: int, n: int, dtype, backend: Backend, machine: MachineModel,
           legal, preds: dict, measured: dict, winner: int, batch: int) -> dict:
    floor = min(
        _GEMM_FLOOR_CANDIDATES,
        key=lambda f: (predict(kernel, m, n, dtype, block_rows=winner, machine=machine,
                               backend=backend, gemm_floor=f, batch=batch).seconds, f),
    )
    kw = dict(block_rows=winner, machine=machine, backend=backend, batch=batch)
    fused = predict("fused_apply_gram", m, n, dtype, **kw)
    unfused = (predict("apply_right", m, n, dtype, **kw).seconds
               + predict("gram", m, n, dtype, **kw).seconds)
    win = preds[winner]
    return {
        "kernel": kernel,
        "backend": backend.kind,
        "arch": backend.arch,
        "dtype": _dtype_name(dtype),
        "shape_class": shape_class(m, n),
        "m": int(m),
        "n": int(n),
        "batch": int(batch),
        "block_rows": int(winner),
        "accum_budget_bytes": int(ACCUM_BUDGET_BYTES[backend.kind]),
        "gemm_width_floor": int(floor),
        "fuse_want_q": bool(fused.seconds < unfused),
        "predicted_read_bytes": win.read_bytes,
        "predicted_write_bytes": win.write_bytes,
        "predicted_dispatches": win.dispatches,
        "predicted_streamed_bytes": win.streamed_bytes,
        "predicted_flops": win.flops,
        "predicted_s": win.seconds,
        "measured_s": measured[winner],
        "candidates": [
            {"block_rows": int(c), "predicted_s": preds[c].seconds,
             "accum_bytes": preds[c].accum_bytes, "measured_s": measured.get(c)}
            for c in sorted(legal)
        ],
    }


def _tune_group(group: tuple[str, ...], m: int, n: int, dtype, backend: Backend,
                machine: MachineModel, timer, reps: int, measure_top: int,
                batch: int) -> list[dict]:
    """One entry for each kernel of ``group`` (kernels that share a split),
    each with the winner picked on their summed time."""
    legal, preds, measured, winner = _search(group, m, n, dtype, backend, machine, timer,
                                             reps, measure_top, batch)
    return [_entry(k, m, n, dtype, backend, machine, legal, preds[k], measured, winner, batch)
            for k in group]


def tune_kernel(kernel: str, m: int, n: int, *, dtype="float32",
                backend: Backend | None = None, machine: MachineModel | None = None,
                timer=None, reps: int = 3, measure_top: int = 3, batch: int = 1) -> dict:
    """Tune one (kernel, shape class) at ``batch``: rank every legal
    candidate by the prior, measure the top ``measure_top`` and the untuned
    split, and return the persistable entry."""
    backend = backend or resolve_backend(None)
    machine = machine or measure_machine(timer=timer, device=backend.device)
    return _tune_group((kernel,), m, n, dtype, backend, machine, timer, reps, measure_top,
                       batch)[0]


def select_winner(entry: dict) -> int:
    """Re-select the winner from an entry's persisted measurements: min
    measured time, ties to the smaller split (the reproducibility contract
    the bench case hard-gates)."""
    measured = [c for c in entry["candidates"] if c.get("measured_s") is not None]
    if not measured:
        raise AutotuneError(
            f"entry {entry.get('kernel')}|{entry.get('shape_class')} has no "
            "measured candidates — not a tuned table"
        )
    best = min(measured, key=lambda c: (c["measured_s"], c["block_rows"]))
    return int(best["block_rows"])


def entry_legal(entry: dict) -> bool:
    """A winner is legal iff it is a positive multiple of the 32-row chunk,
    drawn from the candidate set, its partial buffer fits the budget and
    its splits fit a launch's grid."""
    br = entry["block_rows"]
    cands = {c["block_rows"]: c for c in entry["candidates"]}
    if br not in cands:
        return False
    return (
        br % SUBLANE == 0
        and br >= SUBLANE
        and math.ceil(entry["m"] / br) <= _launch.MAX_SPLITS
        and cands[br]["accum_bytes"] <= entry["accum_budget_bytes"]
        and entry["gemm_width_floor"] >= MIN_GEMM_FLOOR
    )


# ---------------------------------------------------------------------------
# persistence (schema-versioned JSON under results/autotune/)
# ---------------------------------------------------------------------------

_ENTRY_FIELDS = (
    "kernel", "backend", "arch", "dtype", "shape_class", "m", "n", "batch",
    "block_rows", "accum_budget_bytes", "gemm_width_floor", "fuse_want_q",
    "predicted_read_bytes", "predicted_write_bytes", "predicted_dispatches",
    "predicted_streamed_bytes", "predicted_flops", "predicted_s",
    "measured_s", "candidates",
)
_MACHINE_FIELDS = ("mem_bw_bytes_per_s", "flops_per_s", "step_overhead_s")


def validate_table(doc: dict) -> dict:
    """Validate a persisted table; raises :class:`AutotuneSchemaError`."""
    if not isinstance(doc, dict):
        raise AutotuneSchemaError("table must be an object")
    if doc.get("schema_version") != SCHEMA_VERSION:
        raise AutotuneSchemaError(
            f"schema_version: expected {SCHEMA_VERSION}, got "
            f"{doc.get('schema_version')!r} — stale tables are rejected, re-run the tuner"
        )
    if doc.get("backend") not in KINDS:
        raise AutotuneSchemaError(f"backend: must be one of {KINDS}, got {doc.get('backend')!r}")
    machine = doc.get("machine")
    if not isinstance(machine, dict):
        raise AutotuneSchemaError("machine: required object")
    for f in _MACHINE_FIELDS:
        v = machine.get(f)
        if not isinstance(v, (int, float)) or v <= 0:
            raise AutotuneSchemaError(f"machine.{f}: must be positive")
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        raise AutotuneSchemaError("entries: required object")
    for key, e in entries.items():
        if not isinstance(e, dict):
            raise AutotuneSchemaError(f"entries.{key}: must be an object")
        missing = [f for f in _ENTRY_FIELDS if f not in e]
        if missing:
            raise AutotuneSchemaError(f"entries.{key}: missing {missing}")
        want = entry_key(e["kernel"], e["backend"], e["dtype"], e["shape_class"])
        if key != want:
            raise AutotuneSchemaError(f"entries.{key}: key does not match its fields ({want})")
        if not isinstance(e["candidates"], list) or not e["candidates"]:
            raise AutotuneSchemaError(f"entries.{key}: candidates must be a non-empty list")
    return doc


def save_table(doc: dict, out_dir: str = DEFAULT_OUT_DIR) -> str:
    validate_table(doc)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{doc['backend']}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_table(path: str) -> dict:
    with open(path) as f:
        return validate_table(json.load(f))


# ---------------------------------------------------------------------------
# in-process cache
# ---------------------------------------------------------------------------

_INSTALLED: dict[str, dict] = {}
_MACHINE: dict | None = None
_GENERATION = 0


def install(doc: dict) -> int:
    """Merge a validated table into the in-process cache; returns the new
    generation.  Resolution happens per call, so a new table takes effect
    at once for its shape classes and only those."""
    global _MACHINE, _GENERATION
    validate_table(doc)
    _INSTALLED.update(doc["entries"])
    _MACHINE = dict(doc["machine"])
    _GENERATION += 1
    return _GENERATION


def installed() -> dict[str, dict]:
    return dict(_INSTALLED)


def clear() -> None:
    global _MACHINE, _GENERATION
    _INSTALLED.clear()
    _MACHINE = None
    _GENERATION += 1


def generation() -> int:
    return _GENERATION


def machine_constants() -> dict | None:
    """The installed table's measured machine constants (or None): what
    :meth:`repro_torch.serve.planner.CostModel.tuned` prices with."""
    return dict(_MACHINE) if _MACHINE else None


def lookup(kernel: str, m: int, n: int, dtype, backend: Backend | None = None) -> dict | None:
    """The installed entry that sets ``kernel``'s split at (m, n): its own,
    or the entry it shares (:data:`SHARED_SPLIT`)."""
    if not _INSTALLED:
        return None
    be = backend or resolve_backend(None)
    owner = SHARED_SPLIT.get(kernel, kernel)
    return _INSTALLED.get(entry_key(owner, be.kind, dtype, shape_class(m, n)))


def resolve_block_rows(kernel: str, m: int, n: int, dtype, *, explicit: int | None = None,
                       backend: Backend | None = None) -> int | None:
    """The one resolution order: an explicit caller choice (validated, as
    given) > the installed winner for the shape class (clamped) > ``None``,
    the kernel's own shape-derived split."""
    if explicit is not None:
        _launch.check_rows(kernel, explicit)
        return int(explicit)
    e = lookup(kernel, m, n, dtype, backend=backend)
    if e is None:
        return None
    return pick_block_rows(m, e["block_rows"])


# ---------------------------------------------------------------------------
# the driver + CLI
# ---------------------------------------------------------------------------

def tune(shapes, kernels=DEFAULT_KERNELS, *, dtype="float32", device=None, batch: int = 1,
         timer=None, reps: int = 3, measure_top: int = 3, out_dir: str | None = None,
         install_result: bool = True, machine: MachineModel | None = None) -> dict:
    """Tune every (kernel × shape) cell at ``batch`` on ``device`` (the card
    unless ``"cpu"``), build the table document, install it in-process and
    (with ``out_dir``) persist it.  ``gram`` and ``fused_apply_gram`` are
    tuned as one pair when both are asked for.  Returns the document."""
    backend = resolve_backend(device)
    machine = machine or measure_machine(timer=timer, device=backend.device)
    unknown = set(kernels) - set(DEFAULT_KERNELS)
    if unknown:
        raise AutotuneError(f"unknown kernels {sorted(unknown)} (expected {DEFAULT_KERNELS})")
    pair = set(_GRAM_KERNELS) <= set(kernels)
    groups = [_GRAM_KERNELS if pair and k == "gram" else (k,) for k in kernels
              if not (pair and k == "fused_apply_gram")]
    entries = {}
    for m, n in shapes:
        for group in groups:
            for e in _tune_group(group, m, n, dtype, backend, machine, timer, reps,
                                 measure_top, batch):
                entries[entry_key(e["kernel"], backend.kind, dtype, e["shape_class"])] = e
    doc = {
        "schema_version": SCHEMA_VERSION,
        "backend": backend.kind,
        "arch": backend.arch,
        "machine": machine.as_dict(),
        "entries": entries,
    }
    validate_table(doc)
    if install_result:
        install(doc)
    if out_dir:
        save_table(doc, out_dir)
    return doc


def _parse_shapes(spec: str) -> tuple[tuple[int, int], ...]:
    out = []
    for part in spec.split(","):
        m, _, n = part.strip().partition("x")
        out.append((int(m), int(n)))
    return tuple(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.autotune",
        description="roofline-seeded row-split tuner for the Hopper kernels (persists "
                    "winners under results/autotune/<kind>.json)",
    )
    ap.add_argument("--shapes", default="4096x256,1024x64", help="comma-separated MxN shape classes")
    ap.add_argument("--kernels", default=",".join(DEFAULT_KERNELS))
    ap.add_argument("--batch", type=int, default=1, help="leading matrices of each launch")
    ap.add_argument("--out", default=DEFAULT_OUT_DIR)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cpu for the plain route (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes and the persistence round trip")
    args = ap.parse_args(argv)
    shapes = _parse_shapes("256x32" if args.smoke else args.shapes)
    reps = 2 if args.smoke else args.reps
    doc = tune(shapes, tuple(args.kernels.split(",")), device=args.device, batch=args.batch,
               reps=reps, out_dir=args.out)
    path = os.path.join(args.out, f"{doc['backend']}.json")
    reloaded = load_table(path)
    bad = [k for k, e in reloaded["entries"].items()
           if select_winner(e) != e["block_rows"] or not entry_legal(e)]
    if bad:
        print(f"[autotune] ILLEGAL/IRREPRODUCIBLE winners: {bad}")
        return 1
    mc = doc["machine"]
    print(f"[autotune] backend={doc['backend']} arch={doc['arch']} "
          f"bw={mc['mem_bw_bytes_per_s']:.3e} B/s peak={mc['flops_per_s']:.3e} flop/s")
    for key, e in sorted(reloaded["entries"].items()):
        default = default_block_rows(e["kernel"], e["m"], e["n"], batch=e["batch"])
        print(f"[autotune] {key}: block_rows={e['block_rows']} (untuned {default}) "
              f"batch={e['batch']} fused={e['fuse_want_q']} predicted={e['predicted_s']:.3e}s "
              f"measured={e['measured_s']:.3e}s")
    print(f"[autotune] wrote {path} ({len(reloaded['entries'])} entries)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
