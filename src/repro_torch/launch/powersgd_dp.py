"""PowerSGD-TSQR data-parallel training with real collectives across
processes: the port of the reference's ``examples/powersgd_dp.py``.

Trains a two-layer MLP regression model on a (data=2 × model=4) mesh of 8
rank processes (:func:`repro_torch.collective.dist.run_ranks`, all on the
one card unless ``--device cpu``), exchanging gradients as rank-r factors:
the left factor is orthonormalized with the paper's fault-tolerant
butterfly TSQR over the model axis, and a mid-training rank failure is
absorbed by the self-healing variant without interrupting the run.  w1's
rows are split over the model axis and gathered for the forward; w2's
gradient is averaged over the data axis.

Reports data-axis bytes: compressed against a dense all-reduce.  The data
and the initial weights come from a numpy seed (the reference's
``jax.random`` draws cannot be made in torch)::

  PYTHONPATH=src python -m repro_torch.launch.powersgd_dp                # on the card
  PYTHONPATH=src python -m repro_torch.launch.powersgd_dp --device cpu   # 8 CPU ranks, gloo
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.collective import FaultSpec, ShardMapComm
from repro_torch.collective.dist import all_gather, pmean, psum, run_ranks
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.optim import powersgd

__all__ = ["make_inputs", "train", "rank_main", "report", "main"]

D, M = 2, 4                    # data x model mesh
DIN, DH, DOUT = 64, 128, 32    # w1 rows split over model
BATCH = 256                    # samples a data replica
RANK = 8
STEPS = 80
LR = 0.3
SEED = 0
FAULT = {1: 1}                 # model rank 1 dies at exchange 1 of the fault step, respawned


def make_inputs() -> dict[str, np.ndarray]:
    """The example's data and initial state from the numpy seed ``SEED``, f32: each
    data replica's stream ``x`` (D, BATCH, DIN) and targets ``y`` from a
    random two-layer teacher, small random ``w1``, ``w2`` (a zero start
    would make the rank-r sketch singular) and the start basis ``q1``."""
    rng = np.random.default_rng(SEED)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    w_true1, w_true2 = normal(DIN, DH) / 8, normal(DH, DOUT) / 8
    x = normal(D, BATCH, DIN)
    y = np.maximum(x @ w_true1, 0) @ w_true2
    return {"x": x, "y": y, "w1": normal(DIN, DH) * 0.05, "w2": normal(DH, DOUT) * 0.05,
            "q1": normal(DH, RANK)}


def _relu(h):
    # jnp.maximum(h, 0): a tie passes half the gradient, as torch.maximum's does
    return torch.maximum(h, h.new_zeros(()))


def train(mesh, inputs: dict, steps: int = STEPS, fault_step: int = STEPS // 2) -> dict:
    """The example's loop on this rank of the (D, M) data × model ``mesh``:
    ``steps`` steps at LR, the model-axis butterfly losing ``FAULT`` on step
    ``fault_step``.  Returns this rank's results: the loss after each step
    (of data replica 0's stream, through the model line's whole w1), its w1
    rows, w2, the PowerSGD state (``q``, ``e``), the last step's ĝ, the
    validity bit of the fault step, the data-axis byte counts and each
    step's host-clock seconds."""
    dev = mesh.device
    d, m = mesh.index("data"), mesh.index("model")
    rows = DIN // M

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    x, y = tensor(inputs["x"]), tensor(inputs["y"])
    w1 = tensor(inputs["w1"][m * rows:(m + 1) * rows])
    w2, q = tensor(inputs["w2"]), tensor(inputs["q1"])
    e = torch.zeros_like(w1)                  # this rank's rows of the error buffer
    cfg = powersgd.PowerSGDConfig(rank=RANK, error_feedback=True, variant="selfhealing")
    comm = ShardMapComm(M, "model")

    def loss_fn(w1_blk, w2_full, xb, yb):
        w1_full = all_gather(w1_blk, "model", mesh)
        pred = _relu(xb @ w1_full) @ w2_full
        return ((pred - yb) ** 2).mean()

    def step(w1, w2, q, e, fault_spec):
        w1_var, w2_var = w1.requires_grad_(), w2.requires_grad_()
        g1, g2 = torch.autograd.grad(loss_fn(w1_var, w2_var, x[d], y[d]), (w1_var, w2_var))
        w1, w2 = w1.detach(), w2.detach()
        g2_mean = pmean(g2, "data", mesh)     # dense path for w2 (small)
        g1_hat, state, stats = powersgd.compress_grad(
            g1, {"q": q, "e": e}, comm, cfg=cfg,
            psum_data=lambda v: psum(v, "data", mesh),
            psum_model=lambda v: psum(v, "model", mesh),
            n_data=D, fault_spec=fault_spec)
        return w1 - LR * g1_hat, w2 - LR * g2_mean, state["q"], state["e"], g1_hat, stats

    out: dict = {"losses": [], "step_s": [], "valid_at_fault": None}
    for i in range(steps):
        t0 = time.perf_counter()
        faults = FaultSpec.of(FAULT) if i == fault_step else None
        w1, w2, q, e, g1_hat, stats = step(w1, w2, q, e, faults)
        with torch.no_grad():
            pred = _relu(x[0] @ all_gather(w1, "model", mesh)) @ w2
            out["losses"].append(float(((pred - y[0]) ** 2).mean()))
        out["step_s"].append(time.perf_counter() - t0)
        if i == fault_step:
            out["valid_at_fault"] = bool(stats["valid"])
    host = {"w1": w1, "w2": w2, "q": q, "e": e, "g1_hat": g1_hat}
    out.update({k: v.cpu().numpy() for k, v in host.items()})
    out["bytes"] = (stats["data_bytes_compressed"], stats["data_bytes_dense"])
    return out


def rank_main(mesh) -> dict:
    """One rank of the example (``mesh`` is the world's, from
    :func:`~repro_torch.collective.dist.run_ranks`): lay the (D, M) data ×
    model mesh over the world and :func:`train` on it from
    :func:`make_inputs`, made in the rank (a spawned rank reads its
    arguments only after importing the parent's main module, so large
    arguments hold up the spawn of the next rank)."""
    return train(make_smoke_mesh(D, M), make_inputs())


def report(ranks: list[dict], fault_step: int = STEPS // 2) -> bool:
    """Print the example's lines from the ranks' results of :func:`train`
    (rank 0's losses and byte counts) and return its own check: the final
    loss under a quarter of the first."""
    losses = ranks[0]["losses"]
    for i, loss in enumerate(losses):
        if i % 10 == 0 or i == fault_step:
            tag = "  <-- rank failure absorbed by self-healing TSQR" if i == fault_step else ""
            print(f"step {i:3d} loss {loss:.5f}{tag}")
    comp, dense = ranks[0]["bytes"]
    print(f"\nfinal loss {losses[-1]:.5f} (from {losses[0]:.5f})")
    print(f"data-axis bytes/step: compressed={comp} dense={dense} ({dense / comp:.1f}x saved)")
    if losses[-1] < 0.25 * losses[0]:
        return True
    print(f"FAILED: final loss {losses[-1]:.5f} is not below a quarter of the first "
          f"{losses[0]:.5f}", file=sys.stderr)
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where every rank computes (default: the card; 'cpu': gloo on the CPU)")
    args = ap.parse_args(argv)
    ranks = run_ranks(rank_main, D * M, device=args.device)
    return 0 if report(ranks) else 1


if __name__ == "__main__":
    sys.exit(main())
