"""Autotuner honesty, hard-gated end to end (the port of
:mod:`repro.bench.cases.autotune`), on ``device`` (``None``: the card).

  * **legal** — every winner is a multiple of the 32-row chunk, inside
    the partial-buffer budget and the grid, and drawn from the candidate
    set (:func:`repro_torch.kernels.autotune.entry_legal`);
  * **persisted** — the table round-trips through the schema-versioned
    JSON and re-validates on load;
  * **reproducible** — :func:`~repro_torch.kernels.autotune.select_winner`
    over the persisted measurements re-picks each winner;
  * **honest** — for every tuned kernel, a call through the ``ops``
    wrappers with the table installed records exactly the predicted
    committed bytes and dispatch count;
  * **retrace-free** — the second call of every tuned wrapper notes zero
    new ``kernel:<op>`` traces.

The tuned and untuned ``gram`` times ride along warn-gated.  The case
installs the table for its own checks and **clears it before returning**,
so later cases see the untuned splits they were baselined against.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch.bench.registry import BenchFailure, bench_case
from repro_torch.bench.schema import Metric

__all__ = ["KERNELS", "accounting", "case", "run"]

KERNELS = ("gram", "apply_right", "fused_apply_gram", "trailing_update")


def _operands(m: int, n: int, batch: int, device):
    from repro_torch.kernels import autotune as at

    from repro_torch.collective.comm import resolve_device

    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    lead = (batch,) if batch > 1 else ()

    def tensor(*shape, scale=1.0):
        return torch.randn(lead + shape, generator=gen, device=device) * scale

    b = at.trailing_panel_width(n)
    return tensor(m, n), tensor(n, n, scale=1.0 / n), tensor(m, b), tensor(b, n, scale=1.0 / n)


def accounting(entries: dict, m: int, n: int, *, batch: int = 1, device=None,
               kernels=KERNELS) -> dict:
    """With a table installed, run each tuned kernel's ``ops`` wrapper twice
    at (batch, m, n) and return, per kernel, the entry's predicted bytes and
    dispatches beside the second (warm) call's observed ones and traces."""
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import ops, traffic
    from repro_torch.kernels.backend import backend_of

    a, w, q, wt = _operands(m, n, batch, device)
    b = at.trailing_panel_width(n)
    kind = backend_of(a.device).kind
    calls = {
        "gram": lambda: ops.gram(a, use_pallas=True),
        "apply_right": lambda: ops.apply_right(a, w, use_pallas=True),
        "fused_apply_gram": lambda: ops.fused_apply_gram(a, w, use_pallas=True),
        "trailing_update": lambda: ops.trailing_update(a, q, wt, next_width=b, use_pallas=True),
    }
    out = {}
    for kernel in kernels:
        e = entries[at.entry_key(kernel, kind, "float32", at.shape_class(m, n))]
        calls[kernel]()                         # trace with the tuned key
        with traffic.track_traffic() as t:
            calls[kernel]()                     # the measured (warm) call
        rec = next(r for r in t.records if r["op"] == kernel)
        out[kernel] = {
            "block_rows": e["block_rows"],
            "predicted_read_bytes": e["predicted_read_bytes"],
            "observed_read_bytes": rec["read_bytes"],
            "predicted_write_bytes": e["predicted_write_bytes"],
            "observed_write_bytes": rec["write_bytes"],
            "predicted_dispatches": e["predicted_dispatches"],
            "observed_dispatches": rec["dispatches"],
            "warm_traces": rec["traces"],
        }
    return out


def run(m: int = 2048, n: int = 64, reps: int = 3, out_dir: str | None = None,
        batch: int = 1, device=None) -> dict:
    """Tune the (m, n) shape class at ``batch``, persist and reload the
    table, and measure every hard claim; returns the raw measurements."""
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import dispatch as _dispatch
    from repro_torch.kernels import ops, traffic
    from repro_torch.kernels.backend import resolve_backend

    backend = resolve_backend(device)
    dev = backend.device
    out_dir = out_dir or at.DEFAULT_OUT_DIR
    try:
        doc = at.tune([(m, n)], KERNELS, device=dev, batch=batch, reps=reps, out_dir=out_dir)
        path = os.path.join(out_dir, f"{doc['backend']}.json")
        reloaded = at.load_table(path)
        entries = reloaded["entries"]
        acc = accounting(entries, m, n, batch=batch, device=dev)
        g_entry = entries[at.entry_key("gram", backend.kind, "float32", at.shape_class(m, n))]
        default_br = at.default_block_rows("gram", m, n, batch=batch)
        a = _operands(m, n, batch, dev)[0]

        def p50_us(fn):
            with traffic.suppress(), _dispatch.suppress():
                fn()
                samples = []
                for _ in range(max(1, reps)):
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    fn()
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    samples.append(time.perf_counter() - t0)
            return float(np.median(samples)) * 1e6

        us_tuned = p50_us(lambda: ops.gram(a, use_pallas=True))
        us_default = p50_us(lambda: ops.gram(a, use_pallas=True, block_rows=default_br))
        return {
            "m": m, "n": n, "batch": batch, "backend": backend.kind, "arch": backend.arch,
            "path": path,
            "n_entries": len(entries),
            "winners_legal": all(at.entry_legal(e) for e in entries.values()),
            "winners_reproducible": all(at.select_winner(e) == e["block_rows"]
                                        for e in entries.values()),
            "accounting": acc,
            "tuned_block_rows": g_entry["block_rows"],
            "default_block_rows": default_br,
            "us_gram_tuned": us_tuned,
            "us_gram_default": us_default,
            "machine": reloaded["machine"],
        }
    finally:
        at.clear()


def check_accounting(acc: dict) -> None:
    """Raise :class:`BenchFailure` unless every kernel's observed bytes and
    dispatches equal the predicted and its warm call traced nothing."""
    for kernel, row in acc.items():
        for field in ("read_bytes", "write_bytes", "dispatches"):
            if row[f"predicted_{field}"] != row[f"observed_{field}"]:
                raise BenchFailure(
                    f"{kernel}: predicted {field} {row[f'predicted_{field}']} != observed "
                    f"{row[f'observed_{field}']} at tuned block_rows={row['block_rows']}"
                )
        if row["warm_traces"]:
            raise BenchFailure(f"{kernel}: warm tuned-config call performed "
                               f"{row['warm_traces']} new traces (expected 0)")


def case(m: int = 2048, n: int = 64, reps: int = 3, device=None):
    rows = run(m=m, n=n, reps=reps, device=device)
    if not rows["winners_legal"]:
        raise BenchFailure("autotuner selected an illegal winner "
                           "(misaligned, over-budget, or off-candidate)")
    if not rows["winners_reproducible"]:
        raise BenchFailure("winner selection is not reproducible from the persisted "
                           "per-candidate measurements")
    check_accounting(rows["accounting"])
    metrics = {
        "n_entries": Metric(rows["n_entries"], gate="hard", direction="exact"),
        "winners_legal": Metric(1, gate="hard", direction="exact"),
        "winners_reproducible": Metric(1, gate="hard", direction="exact"),
        "artifact_validates": Metric(1, gate="hard", direction="exact"),
    }
    for kernel, acc in rows["accounting"].items():
        metrics[f"{kernel}_hbm_read_bytes"] = Metric(
            acc["observed_read_bytes"], gate="hard", direction="exact", unit="B")
        metrics[f"{kernel}_hbm_write_bytes"] = Metric(
            acc["observed_write_bytes"], gate="hard", direction="exact", unit="B")
        metrics[f"{kernel}_warm_traces"] = Metric(acc["warm_traces"], gate="hard",
                                                  direction="exact")
    metrics.update({
        "us_gram_tuned": Metric(rows["us_gram_tuned"], gate="warn", direction="lower", unit="us"),
        "us_gram_default": Metric(rows["us_gram_default"], gate="warn", direction="lower",
                                  unit="us"),
        "speedup_vs_default": Metric(rows["us_gram_default"] / max(rows["us_gram_tuned"], 1e-9),
                                     gate="warn", direction="higher"),
    })
    return metrics


bench_case(
    "autotune",
    tags=("autotune", "kernels", "backend"),
    params={
        "smoke": {"m": 1024, "n": 32, "reps": 2},
        "full": {"m": 16384, "n": 128, "reps": 5},
    },
)(case)
