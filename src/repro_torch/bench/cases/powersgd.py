"""PowerSGD-TSQR gradient compression: bytes over the data axis vs a dense
all-reduce, and reconstruction quality vs rank (the port of
:mod:`repro.bench.cases.powersgd`), on ``device`` (``None``: the card).
Reconstruction error and compression ratio are hard-gated (deterministic
seeds: a quality regression in the compressor is a real bug); the per-call
wall clock, each call ending in a synchronize on the card, is warn-gated.

The synthetic gradient is built from numpy seeds as the reference builds it;
the PowerSGD start basis is drawn from an explicit ``torch.Generator``
seeded 0 (the reference draws it from ``jax.random.key(0)``, whose bits the
port cannot reproduce).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench.registry import bench_case
from repro_torch.bench.schema import Metric
from repro_torch.collective import SimComm
from repro_torch.collective.comm import resolve_device
from repro_torch.optim import powersgd

__all__ = ["case", "main", "run"]


def _psum_id(x):
    return x


def _psum_model(x):
    """The sum over the simulated model axis (the leading rank axis)."""
    return x.sum(0, keepdim=True).expand_as(x)


def run(ranks=(2, 8, 32, 128), p_model: int = 8, m_loc: int = 256, n: int = 1024,
        spectrum: int = 256, iters: int = 3, device=None):
    device = resolve_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rows = []
    # synthetic gradient with a decaying spectrum (realistic for LM gradients)
    spectrum = min(spectrum, p_model * m_loc, n)
    u, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((p_model * m_loc, spectrum)))
    v, _ = np.linalg.qr(np.random.default_rng(1).standard_normal((n, spectrum)))
    sv = np.logspace(0, -3, spectrum)
    g = torch.from_numpy(((u * sv) @ v.T).astype(np.float32).reshape(p_model, m_loc, n))
    g = g.to(device)
    g_norm = float(torch.linalg.norm(g))
    comm = SimComm(p_model, device)
    for rank in ranks:
        cfg = powersgd.PowerSGDConfig(rank=rank, error_feedback=False)
        gen = torch.Generator(device=device).manual_seed(0)
        state = powersgd.init_state(gen, (m_loc, n), cfg, leading=(p_model,), device=device)

        def fn(gg, st):
            return powersgd.compress_grad(gg, st, comm, cfg=cfg, psum_data=_psum_id,
                                          psum_model=_psum_model, n_data=1)[:2]

        g_hat, state = fn(g, state)
        # one power-iteration refinement (warm basis), as in training
        g_hat, state = fn(g, state)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(g, state)
        sync()
        us = (time.perf_counter() - t0) / iters * 1e6
        err = float(torch.linalg.norm(g - g_hat)) / g_norm
        dense = 4 * p_model * m_loc * n
        comp = 4 * rank * (p_model * m_loc + n)
        rows.append({
            "rank": rank, "rel_error": err,
            "bytes_dense": dense, "bytes_compressed": comp,
            "compression_x": dense / comp, "us_per_call": us,
        })
    return rows


def case(**kw):
    rows = run(**kw)
    metrics = {}
    for r in rows:
        k = r["rank"]
        metrics[f"rel_error_r{k}"] = Metric(
            r["rel_error"], gate="hard", direction="lower", tolerance=0.10)
        metrics[f"compression_x_r{k}"] = Metric(
            r["compression_x"], gate="hard", direction="higher", tolerance=0.01)
        metrics[f"us_per_call_r{k}"] = Metric(
            r["us_per_call"], gate="warn", direction="lower", unit="us")
    return metrics


bench_case(
    "powersgd",
    tags=("timing", "compression", "powersgd"),
    params={
        "smoke": {"ranks": (2, 8, 32), "p_model": 4, "m_loc": 128, "n": 512,
                  "spectrum": 128, "iters": 2},
        "full": {"ranks": (2, 8, 32, 128), "p_model": 8, "m_loc": 256, "n": 1024,
                 "spectrum": 256, "iters": 3},
    },
)(case)


def main(device=None):
    print("# powersgd-tsqr: data-axis bytes + reconstruction vs rank")
    print("rank,rel_error,bytes_dense,bytes_compressed,compression_x,us_per_call")
    rows = run(device=device)
    for r in rows:
        print(f"{r['rank']},{r['rel_error']:.4f},{r['bytes_dense']},"
              f"{r['bytes_compressed']},{r['compression_x']:.1f},{r['us_per_call']:.0f}")
    return rows


if __name__ == "__main__":
    main()
