"""Roofline analysis (the port of :mod:`repro.bench.cases.roofline`): the
CholeskyQR2 kernel pipeline's device-memory model, fused vs unfused, and the
tuned kernel model of the installed autotune tables.

The registered case models the CQR2 pipeline's memory terms — fused (2 tall
sweeps for R, 3 and a Q₁ write for the full Q) vs unfused (4 sweeps, 2 tall
writes) at reference TSQR shapes — as bytes over the H100's data-sheet
memory bandwidth.  The bytes are *measured*: each pipeline runs at two small
probe heights under :func:`repro_torch.kernels.traffic.track_traffic` and
the exact affine-in-m totals are extrapolated, so the fused/unfused ratio
(hard-gated) follows the pipelines' code.

The reference's other half reads its dry-run records — the partitioned HLO
of production TPU meshes (``launch/dryrun.py``), which has no counterpart on
one card (ROADMAP A.3f) — and reports per-cell roofline fractions when they
exist; with none it reports ``n_cells`` 0, which is what the port reports.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.bench.registry import bench_case
from repro_torch.bench.schema import Metric

__all__ = ["CQR2_SHAPES", "HBM_BW", "OUT_PATH", "case", "cqr2_rows", "main",
           "markdown_table", "tuned_markdown", "tuned_tables"]

# H100 SXM 80GB (HBM3) data-sheet memory bandwidth, bytes/s: the figure the
# kernels' bounds use.
HBM_BW = 3.35e12

# Reference tall-skinny shapes for the CQR2 model (per-rank panels of the
# production TSQR: m_local × n at bf16).
CQR2_SHAPES = ((1 << 20, 128), (1 << 22, 256), (1 << 24, 512))

OUT_PATH = os.path.join("results", "bench_torch", "roofline.md")


def cqr2_rows(shapes=CQR2_SHAPES, dtype: str = "bfloat16", hbm_bw: float = HBM_BW,
              device=None) -> list[dict]:
    """Device-memory model of CholeskyQR2, fused vs unfused pipelines, on
    ``device`` (``None``: the card).  Expected shape of the result: unfused
    ≈ 4 panel reads + 2 panel writes, fused full-Q ≈ 3 + 2, fused R-only =
    exactly 2 reads and no tall write."""
    import torch

    from repro_torch.collective.comm import resolve_device
    from repro_torch.kernels import ops, traffic

    device = resolve_device(device)
    dt = getattr(torch, dtype)
    pipelines = {
        "unfused": lambda a: ops.cholesky_qr2(a, fused=False),
        "fused_q": lambda a: ops.cholesky_qr2(a),
        "fused_r": lambda a: ops.cholesky_qr2_r(a),
    }

    def measured(m, n, run):
        with traffic.track_traffic() as t:
            run(torch.zeros((m, n), dtype=dt, device=device))   # bytes depend on shapes only
        return t.read_bytes + t.write_bytes

    rows = []
    for m, n in shapes:
        m1, m2 = 2 * n, 4 * n               # cheap probes; totals affine in m
        by = {}
        for name, run in pipelines.items():
            b1, b2 = measured(m1, n, run), measured(m2, n, run)
            by[name] = b1 + (b2 - b1) * (m - m1) // (m2 - m1)
        rows.append({
            "m": m, "n": n,
            "unfused_bytes": by["unfused"],
            "fused_q_bytes": by["fused_q"],
            "fused_r_bytes": by["fused_r"],
            "unfused_s": by["unfused"] / hbm_bw,
            "fused_q_s": by["fused_q"] / hbm_bw,
            "fused_r_s": by["fused_r"] / hbm_bw,
            "speedup_r": by["unfused"] / by["fused_r"],
            "speedup_q": by["unfused"] / by["fused_q"],
        })
    return rows


def markdown_table(rows: list[dict]) -> str:
    """The CQR2 model as a markdown table."""
    out = ("| shape | unfused B | fused-Q B | fused-R B | unfused s | fused-R s | "
           "speedup R | speedup Q |\n|---|---|---|---|---|---|---|---|\n")
    for r in rows:
        out += (f"| {r['m']}x{r['n']} | {r['unfused_bytes']} | {r['fused_q_bytes']} | "
                f"{r['fused_r_bytes']} | {r['unfused_s']:.3e} | {r['fused_r_s']:.3e} | "
                f"{r['speedup_r']:.2f} | {r['speedup_q']:.2f} |\n")
    return out


def tuned_tables(dirpath: str | None = None) -> list[dict]:
    """Every valid persisted autotune table under ``results/autotune/``
    (skipping files of another schema or backend — they must be tuned
    again, not read)."""
    from repro_torch.kernels import autotune as at

    dirpath = dirpath or at.DEFAULT_OUT_DIR
    docs = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        try:
            docs.append(at.load_table(path))
        except (at.AutotuneError, json.JSONDecodeError, OSError):
            continue
    return docs


def tuned_markdown(docs: list[dict], device=None) -> str:
    """The tuned-model report section: the measured machine constants and
    each entry's predicted time beside its timed winner, and the CQR2 model
    re-priced at the table's *measured* bandwidth."""
    out = "\n## Tuned kernel model (results/autotune/)\n\n"
    for doc in docs:
        mc = doc["machine"]
        out += (f"backend **{doc['backend']}** (arch `{doc['arch']}`): "
                f"measured bw {mc['mem_bw_bytes_per_s']:.3e} B/s, "
                f"peak {mc['flops_per_s']:.3e} flop/s\n\n")
        out += ("| kernel | shape class | batch | block_rows | floor | fuse | "
                "predicted s | measured s |\n|---|---|---|---|---|---|---|---|\n")
        for _, e in sorted(doc["entries"].items()):
            out += (f"| {e['kernel']} | {e['shape_class']} | {e['batch']} | "
                    f"{e['block_rows']} | {e['gemm_width_floor']} | {e['fuse_want_q']} | "
                    f"{e['predicted_s']:.3e} | {e['measured_s']:.3e} |\n")
        out += ("\nCQR2 model at the measured bandwidth (fused R-only vs unfused):\n\n"
                "| shape | unfused s | fused-R s | speedup |\n|---|---|---|---|\n")
        for r in cqr2_rows(hbm_bw=mc["mem_bw_bytes_per_s"], device=device):
            out += (f"| {r['m']}x{r['n']} | {r['unfused_s']:.3e} | "
                    f"{r['fused_r_s']:.3e} | {r['speedup_r']:.2f} |\n")
        out += "\n"
    return out


def case(device=None):
    # -- the CQR2 kernel-pipeline memory model: the ratio hard-gated --------
    metrics = {}
    for r in cqr2_rows(device=device):
        key = f"m{r['m']}_n{r['n']}"
        metrics[f"cqr2_speedup_r_{key}"] = Metric(r["speedup_r"], gate="hard",
                                                  direction="higher")
        metrics[f"cqr2_fused_r_hbm_s_{key}"] = Metric(r["fused_r_s"], gate="warn",
                                                      direction="lower", unit="s")
        metrics[f"cqr2_unfused_hbm_s_{key}"] = Metric(r["unfused_s"], gate="warn",
                                                      direction="lower", unit="s")
    # -- the dry-run cells: no dry-run records on the port (module doc) ------
    metrics["n_cells"] = Metric(0, gate="warn", direction="higher")
    return metrics


bench_case("roofline", tags=("roofline", "dryrun"))(case)


def main(device=None):
    """Print the CQR2 model and write it, with the installed tables' tuned
    model, to ``results/bench_torch/roofline.md``."""
    print("# CQR2 memory roofline (bf16 panels, H100 data-sheet bandwidth): "
          "fused vs unfused pipeline")
    print("m,n,unfused_s,fused_q_s,fused_r_s,speedup_q,speedup_r")
    rows = cqr2_rows(device=device)
    for r in rows:
        print(f"{r['m']},{r['n']},{r['unfused_s']:.4e},{r['fused_q_s']:.4e},"
              f"{r['fused_r_s']:.4e},{r['speedup_q']:.2f},{r['speedup_r']:.2f}")
    os.makedirs(os.path.dirname(OUT_PATH), exist_ok=True)
    docs = tuned_tables()
    with open(OUT_PATH, "w") as f:
        f.write(markdown_table(rows))
        if docs:
            f.write(tuned_markdown(docs, device=device))
    return rows


if __name__ == "__main__":
    main()
