"""CholeskyQR2 kernel pipeline — device-memory bytes and wall time,
hard-gated (the port of :mod:`repro.bench.cases.kernels`), on ``device``
(``None``: the card; the Hopper kernels there, their plain versions on the
CPU).

The fused pipeline's claim is a number: the TSQR local QR (CholeskyQR2's
R factor) streams the tall operand exactly **2** times against the
unfused 4.  :mod:`repro_torch.kernels.traffic` records every ``ops`` call's
bytes, and the case hard-gates the sweep counts, the exact byte totals of
both pipelines and their ratio; the fused R must match the unfused R and
the fused Q must be orthonormal to CQR2 tolerance
(:class:`~repro_torch.bench.registry.BenchFailure` otherwise).  Timings
ride along warn-gated, each call ending in a synchronize.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench.registry import BenchFailure, bench_case
from repro_torch.bench.schema import Metric

__all__ = ["case", "run"]

ORTHO_TOL = 3e-5          # the CQR2 test tolerance (f32)


def run(m: int = 4096, n: int = 64, use_pallas: bool = True, iters: int = 3,
        device=None) -> dict:
    """Fused vs unfused CQR2 under the traffic tracker: the byte records,
    timings and numerical-safety measurements."""
    from repro_torch.collective.comm import resolve_device
    from repro_torch.kernels import ops, traffic

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with traffic.track_traffic() as t_fused:
        r_fused = ops.cholesky_qr2_r(a, use_pallas=use_pallas)
    with traffic.track_traffic() as t_unfused:
        _, r_unfused = ops.cholesky_qr2(a, use_pallas=use_pallas, fused=False)
    q_fused, r_full = ops.cholesky_qr2(a, use_pallas=use_pallas)

    eye = torch.eye(n, dtype=torch.float32, device=device)
    ortho = float((q_fused.T @ q_fused - eye).abs().max())
    r_dev = float((r_fused - r_unfused).abs().max() / r_unfused.abs().max())
    r_consistent = bool(torch.equal(r_fused, r_full))

    def clock(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
            sync()
        return (time.perf_counter() - t0) / iters * 1e6

    us_fused = clock(lambda: ops.cholesky_qr2_r(a, use_pallas=use_pallas))
    us_unfused = clock(lambda: ops.cholesky_qr2(a, use_pallas=use_pallas, fused=False)[1])
    return {
        "m": m, "n": n,
        "fused": t_fused.as_dict(),
        "unfused": t_unfused.as_dict(),
        "fused_total_bytes": t_fused.total_bytes,
        "unfused_total_bytes": t_unfused.total_bytes,
        "ortho_err": ortho,
        "r_rel_dev": r_dev,
        "r_consistent": r_consistent,
        "us_fused_r": us_fused,
        "us_unfused_r": us_unfused,
    }


def case(m: int = 4096, n: int = 64, iters: int = 3, device=None):
    rows = run(m=m, n=n, use_pallas=True, iters=iters, device=device)
    if rows["ortho_err"] > ORTHO_TOL:
        raise BenchFailure(f"fused CQR2 orthogonality {rows['ortho_err']:.2e} exceeds "
                           f"tolerance {ORTHO_TOL:.0e}")
    if not rows["r_consistent"]:
        raise BenchFailure("cholesky_qr2_r disagrees with cholesky_qr2(a)[1]")
    if rows["r_rel_dev"] > 1e-5:
        raise BenchFailure(f"fused R deviates from unfused R by {rows['r_rel_dev']:.2e}")
    hard = dict(gate="hard", direction="exact")
    return {
        "tall_sweeps_fused": Metric(rows["fused"]["tall_sweeps"], **hard),
        "tall_sweeps_unfused": Metric(rows["unfused"]["tall_sweeps"], **hard),
        "hbm_read_bytes_fused": Metric(rows["fused"]["read_bytes"], **hard, unit="B"),
        "hbm_read_bytes_unfused": Metric(rows["unfused"]["read_bytes"], **hard, unit="B"),
        "hbm_write_bytes_fused": Metric(rows["fused"]["write_bytes"], **hard, unit="B"),
        "hbm_write_bytes_unfused": Metric(rows["unfused"]["write_bytes"], **hard, unit="B"),
        "hbm_bytes_ratio": Metric(rows["fused_total_bytes"] / rows["unfused_total_bytes"],
                                  gate="hard", direction="lower"),
        "ortho_err": Metric(rows["ortho_err"], gate="warn", direction="lower"),
        "us_fused_r": Metric(rows["us_fused_r"], gate="warn", direction="lower", unit="us"),
        "us_unfused_r": Metric(rows["us_unfused_r"], gate="warn", direction="lower", unit="us"),
    }


bench_case(
    "kernels",
    tags=("kernels", "hbm", "timing"),
    params={
        "smoke": {"m": 2048, "n": 32, "iters": 2},
        "full": {"m": 65536, "n": 128, "iters": 5},
    },
)(case)
