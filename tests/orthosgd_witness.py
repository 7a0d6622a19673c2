"""OrthoSGD's first step on olmo-1b's tied embedding: its CholeskyQR2 on
the card and on the CPU, in both packages.

Phase 11 of ``chip_smoke.py`` trains olmo-1b at its published widths, cut
to 2 layers, with OrthoSGD over 4 replicas (2 × 2048 tokens each) under
BLANK.  The step orthonormalizes each matrix's Nesterov direction with
CholeskyQR2, its Grams summed by the butterfly over 4 row shards.  With
each shard's f32 Gram formed as one product over its rows, the first step
poisoned the tied embedding (50 304 × 2048) on an H100.  This script takes
that direction apart, on the card and, carried off it, on the CPU.

On the card (torch only, no JAX)::

    python3 tests/orthosgd_witness.py card

computes the embedding's combined gradient of the first step from that
run's weights and batch, and prints: the direction's f32 Gram against its
float64 Gram (max |error| and least eigenvalue) for each way of forming
it; the port's CholeskyQR2 round by round (:func:`port_trace`) with the
Grams as one product (``one``) and as the sum of row blocks (``blocks``,
:func:`repro_torch.optim.lowrank._gram`), over the step's 4 row shards and
over none; and whether ``orthosgd.update`` leaves the embedding finite.
::

    python3 tests/orthosgd_witness.py export --part 0 [1 …] --parts 4 --out chiprun_out/orthosgd

writes rows [part·m/parts, (part+1)·m/parts) of that gradient to
``OUT/grad_<part>.npz`` (compressed) as the high 16 bits of each float32:
the gradient is a mean of bf16 replica gradients, so its low 16 bits are
zero, which the export checks.  Export the parts in as many runs as the
space for bringing them back needs: every run must print the same SHA-256.

On the CPU (both packages)::

    PYTHONPATH=src python tests/orthosgd_witness.py witness chiprun_out/orthosgd

joins the parts and prints, on the same f32 direction, the port's trace
in both forms and the reference's (:func:`ref_trace`, its
``ft_cqr2_q``/``gram_cqr2_q`` bit for bit), and whether each package's
``orthosgd.update`` (``ft_shards`` 4, as the trainer sets it) leaves the
embedding finite.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SHARDS = 4


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def least_eig(g) -> float | None:
    """The least eigenvalue of a Gram in float64 (LAPACK, on the host);
    None when the Gram is not finite."""
    g = np.asarray(g, np.float64)
    return float(np.linalg.eigvalsh(g)[0]) if np.isfinite(g).all() else None


def card_grad():
    """The tied embedding's combined gradient (f32) of the first step of
    phase 11's OrthoSGD run: its trainer (as ``trainer_scenario_run``
    builds it), weights and first batch, and the BLANK combine."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models import api
    from repro_torch.runtime import trainer as T
    from repro_torch.runtime.elastic import ReplicaMesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cfg = dataclasses.replace(get_config(cs.OLMO_ARCH), n_layers=cs.TRAIN_CUT_LAYERS)
    tr = T.Trainer(
        cfg,
        T.TrainerConfig(steps=2, log_every=10**9, ckpt_every=0,
                        ckpt_dir=str(ROOT / "build" / "orthosgd_witness"),
                        optimizer="orthosgd", on_failure="blank", seed=0),
        ReplicaMesh.of((SHARDS, 1), ("data", "model")),
        DataConfig(vocab=cfg.vocab, seq_len=cs.TRAIN_SEQ_LEN, global_batch=2 * SHARDS,
                   family=cfg.family, d_model=cfg.d_model),
        device="cuda")
    p0, _ = tr.init_state()
    batch = tr._device_batch(SyntheticCorpus(tr.data_cfg, "cuda").host_batch(0))
    _, grads = T.ft_replica_grad(lambda p, b: api.loss_fn(p, b, cfg), p0, batch, SHARDS)
    return grads["embed"]["tok"]


def direction(grad):
    """OrthoSGD's first Nesterov direction of ``grad`` (zero momentum),
    through ``orthosgd.update``'s own arithmetic."""
    import torch

    from repro_torch.optim import orthosgd

    beta = orthosgd.OrthoSGDConfig().momentum
    m = beta * torch.zeros_like(grad) + grad
    return grad + beta * m


def port_trace(x, shards: int, form: str):
    """The port's CholeskyQR2 of ``x`` as OrthoSGD's step runs it
    (``ft_cqr2_q(x, shards)``: each round's Gram summed by the butterfly
    over ``shards`` row shards; ``shards <= 1`` is ``gram_cqr2_q``), round
    by round, with each shard's Gram as one product (``form="one"``) or as
    ``lowrank._gram``'s sum of row blocks (``"blocks"``, what the port
    runs).  Per round: the input, the f32 Gram's least eigenvalue beside
    the ridge, the Cholesky's ``info`` (0: it factored; k: column k's
    pivot was not positive), its NaN pivots and least pivot over the
    columns it factored, and the output.  Returns the rounds and, for
    ``"blocks"``, whether the last output is ``ft_cqr2_q``'s bit for bit."""
    import torch

    from repro_torch.collective import SimComm, ft_allreduce, make_plan
    from repro_torch.optim import lowrank
    from repro_torch.optim.ftqr import _distribute_rows, ft_cqr2_q

    local = lowrank._gram if form == "blocks" else (lambda y: y.mT @ y)

    def gram(y):
        if shards <= 1:
            return local(y)
        plan = make_plan("redundant", shards, None)
        g, _ = ft_allreduce(local(_distribute_rows(y, shards)), SimComm(shards, y.device),
                            op="gram_sum", plan=plan)
        return g[int(np.argmax(plan.final_valid))]

    rounds, y = [], x.float()
    for _ in range(2):
        g = gram(y)
        ridged = lowrank._gram_ridge(g)
        low, info = torch.linalg.cholesky_ex(ridged)
        info = int(info)
        pivots = low.diagonal()[: info - 1 if info else None]
        out = lowrank._cqr_round(y, g)
        finite = torch.isfinite(out)
        bad = (~finite).any(0).nonzero().flatten().tolist()
        rounds.append({
            "in_finite": bool(torch.isfinite(y).all()),
            "gram_least_eig": least_eig(g.double().cpu().numpy()),
            "ridge": float((ridged - g).diagonal().mean()),
            "info": info,
            "nan_pivots": int(torch.isnan(pivots).sum()),
            "least_pivot": float(pivots.min()) if pivots.numel() else None,
            "least_pivot_at": int(pivots.argmin()) if pivots.numel() else None,
            "finite": not bad,
            "largest_finite": float(torch.where(finite, out, 0).abs().max()),
            "bad_columns": len(bad), "first_bad_columns": bad[:8]})
        y = out
    if form != "blocks":
        return rounds, None
    q = ft_cqr2_q(x.float(), shards)
    return rounds, torch.equal(y.view(torch.int32), q.view(torch.int32))


def print_traces(where: str, x) -> None:
    for form in ("one", "blocks"):
        for shards in (SHARDS, 0):
            rounds, same = port_trace(x, shards, form)
            for k, r in enumerate(rounds, 1):
                print(f"{where}, port, Grams as {form}, {shards} shards, round {k}: {r}",
                      flush=True)
            if same is not None:
                print(f"{where}, port, {shards} shards: the trace is ft_cqr2_q bit for bit: "
                      f"{same}", flush=True)


def port_update_finite(grad) -> bool:
    import torch

    from repro_torch.optim import orthosgd

    cfg = orthosgd.OrthoSGDConfig(ft_shards=SHARDS)
    params = {"tok": torch.zeros(grad.shape, dtype=torch.bfloat16, device=grad.device)}
    new_p, _ = orthosgd.update(cfg, params, {"tok": grad}, orthosgd.init(params))
    return bool(torch.isfinite(new_p["tok"]).all())


def card() -> None:
    grad = card_grad()
    import torch

    from repro_torch.optim import lowrank
    from repro_torch.optim.ftqr import _distribute_rows

    x = direction(grad)
    print(f"f32 direction sha256 {sha(x.cpu().numpy())}; allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}", flush=True)
    want = x.double().mT @ x.double()
    print(f"float64 Gram: least eigenvalue {least_eig(want.cpu().numpy()):.6e}, largest entry "
          f"{float(want.abs().max()):.6e}", flush=True)
    m, n = x.shape
    xd = _distribute_rows(x, SHARDS)
    forms = {
        "one product": lambda: x.mT @ x,
        f"{SHARDS} row shards, one product each, summed": lambda: (xd.mT @ xd).sum(0),
        f"lowrank._gram (blocks of {lowrank.GRAM_ROWS} rows)": lambda: lowrank._gram(x),
        f"{SHARDS} row shards, lowrank._gram each, summed": lambda: lowrank._gram(xd).sum(0),
    }
    for rows in (3144, 786, 393):
        forms[f"blocks of {rows} rows, summed"] = (
            lambda rows=rows: (x.view(m // rows, rows, n).mT @ x.view(m // rows, rows, n)).sum(0))
    for label, form in forms.items():
        g = form()
        print(f"card f32 Gram, {label}: max |error| {float((g.double() - want).abs().max()):.6e}, "
              f"least eigenvalue {least_eig(g.double().cpu().numpy()):.6e}", flush=True)
        del g
    del xd
    print_traces("card", x)
    print(f"card, port orthosgd.update (ft_shards {SHARDS}): the embedding finite "
          f"{port_update_finite(grad)}", flush=True)


def export(parts_: list[int], parts: int, out: Path) -> None:
    grad = card_grad()
    import torch

    bits = grad.view(torch.int32).cpu().numpy()
    low = int(np.count_nonzero(bits & 0xFFFF))
    print(f"grad {tuple(grad.shape)} {grad.dtype} sha256 {sha(bits)}, elements with low 16 "
          f"bits set {low}; f32 direction sha256 {sha(direction(grad).cpu().numpy())}",
          flush=True)
    if low:
        raise SystemExit("the gradient does not fit in its high 16 bits")
    bits = (bits >> 16).astype(np.int16)
    out.mkdir(parents=True, exist_ok=True)
    for part in parts_:
        rows = np.array_split(np.arange(bits.shape[0]), parts)[part]
        path = out / f"grad_{part}.npz"
        np.savez_compressed(path, bits=bits[rows[0]:rows[-1] + 1])
        print(f"wrote rows {rows[0]}..{rows[-1]} to {path}, {path.stat().st_size} bytes",
              flush=True)


def ref_trace(x, shards: int):
    """The reference's ``ft_cqr2_q(x, shards)`` (``gram_cqr2_q`` when
    ``shards <= 1``), its round body spelled out, with each round's input,
    f32 Gram's least eigenvalue, ridge, the first column where
    ``jnp.linalg.cholesky`` gave NaN, and output."""
    import jax.numpy as jnp
    import jax.scipy.linalg as jsl

    from repro.collective import SimComm, ft_allreduce, make_plan
    from repro.optim.ftqr import _distribute_rows
    from repro.optim.lowrank import _gram_ridge

    def gram(y):
        if shards <= 1:
            return jnp.einsum("...mi,...mj->...ij", y, y, preferred_element_type=jnp.float32)
        plan = make_plan("redundant", shards, None)
        yd = _distribute_rows(y, shards)
        g_loc = jnp.einsum("...mi,...mj->...ij", yd, yd, preferred_element_type=jnp.float32)
        g_sum, _ = ft_allreduce(g_loc, SimComm(shards), op="gram_sum", plan=plan)
        return g_sum[int(np.argmax(plan.final_valid))]

    rounds, y = [], jnp.asarray(x, jnp.float32)
    for _ in range(2):
        g = gram(y)
        ridged = _gram_ridge(g)
        low = jnp.linalg.cholesky(ridged)
        r = jnp.swapaxes(low, -1, -2)
        out = jnp.swapaxes(jsl.solve_triangular(
            jnp.swapaxes(r, -1, -2), jnp.swapaxes(y, -1, -2), lower=True), -1, -2)
        g_np, out_np = np.asarray(g), np.asarray(out)
        nan_cols = np.flatnonzero(~np.isfinite(np.diagonal(np.asarray(low))))
        bad = np.flatnonzero(~np.isfinite(out_np).all(0))
        rounds.append({
            "in_finite": bool(np.isfinite(np.asarray(y)).all()),
            "gram_least_eig": least_eig(g_np),
            "ridge": float(np.diagonal(np.asarray(ridged) - g_np).mean()),
            "cholesky_nan_from_column": int(nan_cols[0]) if nan_cols.size else None,
            "finite": not bad.size,
            "largest_finite": float(np.abs(np.where(np.isfinite(out_np), out_np, 0)).max()),
            "bad_columns": int(bad.size), "first_bad_columns": bad[:8].tolist()})
        y = out
    return rounds, np.asarray(y)


def witness(src: Path) -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import jax_reference  # noqa: F401  (before any repro import)
    import jax.numpy as jnp
    import ml_dtypes
    import torch
    from repro.optim import ftqr as jf
    from repro.optim import lowrank as jl
    from repro.optim import orthosgd as jo

    bits = np.concatenate([np.load(p)["bits"] for p in sorted(src.glob("grad_*.npz"),
                                                              key=lambda p: int(p.stem[5:]))])
    g32 = (bits.astype(np.uint16).astype(np.uint32) << 16).view(np.float32)
    grad = torch.from_numpy(g32)
    x = direction(grad)
    print(f"grad {bits.shape} float32 sha256 {sha(g32.view(np.int32))}; f32 direction sha256 "
          f"{sha(x.numpy())}", flush=True)
    print_traces("CPU", x)
    xn = x.numpy()
    for shards in (SHARDS, 0):
        rounds, q = ref_trace(xn, shards)
        want = np.asarray(jf.ft_cqr2_q(jnp.asarray(xn), shards) if shards > 1
                          else jl.gram_cqr2_q(jnp.asarray(xn)))
        for k, r in enumerate(rounds, 1):
            print(f"CPU, reference, {shards} shards, round {k}: {r}", flush=True)
        print(f"CPU, reference, {shards} shards: the trace is the reference's bit for bit: "
              f"{q.view(np.int32).tobytes() == want.view(np.int32).tobytes()}", flush=True)
    # the trainer hands orthosgd.update the f32 combined gradient and the
    # model's bf16 weights; the weights' values do not reach the direction
    params = {"tok": jnp.zeros(bits.shape, ml_dtypes.bfloat16)}
    new_p, _ = jo.update(jo.OrthoSGDConfig(ft_shards=SHARDS), params, {"tok": jnp.asarray(g32)},
                         jo.init(params))
    print(f"CPU, reference orthosgd.update (ft_shards {SHARDS}): the embedding finite "
          f"{bool(np.isfinite(np.asarray(new_p['tok'], np.float32)).all())}", flush=True)
    print(f"CPU, port orthosgd.update (ft_shards {SHARDS}): the embedding finite "
          f"{port_update_finite(grad)}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("card")
    ex = sub.add_parser("export")
    ex.add_argument("--part", type=int, nargs="+", required=True)
    ex.add_argument("--parts", type=int, default=4)
    ex.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "orthosgd")
    wi = sub.add_parser("witness")
    wi.add_argument("src", type=Path)
    args = ap.parse_args()
    if args.cmd == "card":
        card()
    elif args.cmd == "export":
        export(args.part, args.parts, args.out)
    else:
        witness(args.src)


if __name__ == "__main__":
    main()
