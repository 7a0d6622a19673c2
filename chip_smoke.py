#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main path on one GPU.

    python3 chip_smoke.py

The main path is the paper's workload: a tall-skinny matrix row-distributed
over P = 8 ranks, factored by fault-tolerant TSQR whose local QR is
CholeskyQR2 on the hand-written Hopper kernels (``local_r="cqr2_pallas"``).
All eight ranks live on the one card with a leading (P,) axis, so each
CholeskyQR2 sweep is one kernel launch for every rank.

Phases (each raises on failure; the script then exits non-zero):

1. build the kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
2. print the card's name and power limit;
3. hold each kernel against its plain PyTorch version on the card (f32 and
   bf16, ragged rows, a P = 8 batch, widths 32/128/256, k != n), check the
   bitwise contracts (fused ≡ gram(apply_right), want_q=False ≡ True,
   R-only ≡ full-Q R) and that two runs give the same bits;
4. drive ``factorize`` at 2^20 x 32 (all four variants, fault-free and with
   rank 5 dying at exchange 1), at 2^22 x 128 (redundant, selfhealing), with
   ``compute_q`` at 2^20 x 32, and the explicit-Q CholeskyQR2 of the kernel
   layer; check validity against the plan, every survivor's R against a
   float64 Householder R of the same matrix, the orthogonality of Q, and one
   launch of each CholeskyQR2 kernel per factorization;
5. time each kernel (CUDA events, median over repeats) beside its plain
   version, one PyTorch library call computing the same function, and its
   bound, and time ``factorize`` end to end.

The kernel checks' and main path's inputs are drawn on the card from fixed
seeds.  float32 products run in full float32 (TF32 off).  The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

P = 8
MAIN_SHAPES = {"paper_fig": (P, (1 << 20) // P, 32), "powersgd_panel": (P, (1 << 22) // P, 128)}
HEADLINE = "powersgd_panel"
VARIANTS = ("tree", "redundant", "replace", "selfhealing")
# tests/test_kernels.py's tolerances; for the kernels held against their
# plain versions they bound max|got - want| / max|want| (sums of up to 2^19
# terms run in another order than cuBLAS's).
TOL = {"float32": 5e-4, "bfloat16": 3e-2}
R_TOL = 5e-4     # survivors' R vs float64 truth, relative to max|R| (tests/test_tsqr.py)
# The suite's R_TOL sits three decades above what full-f32 kernels give
# (1.4e-7 to 3.4e-7 on an H100), and CholeskyQR2's second pass repairs a
# coarse first Gram, so R_TOL alone would pass a reduced-precision (TF32)
# sweep.  Two tighter limits, about ten times the sound readings, catch it:
# on the main path's R, and on each f32 kernel against a float64 product.
R_TIGHT = 4e-6
F64_TOL = 1e-5
ORTHO_TOL = 2e-5
# H100 SXM data-sheet peaks: HBM3 bytes/s and
# f32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
REPLACES = {
    "gram": "src/repro/kernels/gram.py:107",
    "fused_apply_gram": "src/repro/kernels/fused_apply_gram.py:116",
    "apply_right": "src/repro/kernels/apply_right.py:62",
}
# The path whose run gives each kernel's ``launches``: factorize (the TSQR
# main path) runs CholeskyQR2 R-only; Q's sweep 3 is only in the kernel
# layer's explicit-Q ``ops.cholesky_qr2``.  Each path's counts start at 0.
KERNEL_PATH = {"gram": "factorize", "fused_apply_gram": "factorize",
               "apply_right": "cholesky_qr2"}


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smoke = Smoke(torch)
    smoke.build()
    card = smoke.card()
    smoke.kernel_checks()
    smoke.main_path()
    smoke.timings()
    log(json.dumps({"kernels": smoke.kernel_rows()}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


class Smoke:
    def __init__(self, torch):
        from repro_torch.kernels import _build, dispatch, ops, ref
        from repro_torch.kernels.apply_right import apply_right
        from repro_torch.kernels.fused_apply_gram import fused_apply_gram
        from repro_torch.kernels.gram import gram

        self.torch = torch
        self.build_mod, self.dispatch, self.ops, self.ref = _build, dispatch, ops, ref
        self.kernels = {"gram": gram, "fused_apply_gram": fused_apply_gram,
                        "apply_right": apply_right}
        self.gen = torch.Generator(device="cuda")
        self.errors: dict[str, float] = {}
        self.launches: dict[str, dict[str, int]] = {}  # path -> kernel -> count
        self.times: dict[tuple[str, str], dict] = {}

    # -- helpers --------------------------------------------------------------

    def randn(self, shape, seed, dtype=None):
        torch = self.torch
        self.gen.manual_seed(seed)
        x = torch.randn(shape, generator=self.gen, device="cuda")
        return x if dtype is None else x.to(dtype)

    def time_ms(self, fn, repeats: int = 7, inner: int = 5) -> float:
        """Median over ``repeats`` of CUDA-event times of ``inner`` calls."""
        torch = self.torch
        for _ in range(2):
            fn()
        samples = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / inner)
        return statistics.median(samples)

    def rel_err(self, got, want) -> float:
        if want.dtype != self.torch.float64:
            got, want = got.float(), want.float()
        return ((got - want).abs().max() / want.abs().max()).item()

    # -- phase 1: build -------------------------------------------------------

    def build(self) -> None:
        t0 = time.perf_counter()
        self.build_mod.build_all()
        log(f"[build] {len(self.build_mod.KERNELS)} kernel libraries in "
            f"{time.perf_counter() - t0:.1f} s ({self.build_mod.build_dir()})")
        for name, lines in self.build_mod.ptxas_report().items():
            regs = [ln.split("Used ")[1].split(",")[0] for ln in lines if "Used " in ln]
            spills = [ln for ln in lines if "spill" in ln and not ln.startswith("0 bytes")]
            log(f"[build] {name}: {', '.join(regs)}; spilling variants: {len(spills)}")

    # -- phase 2: card --------------------------------------------------------

    def card(self) -> str:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
        log(f"[card] {out[0]}")
        return out[0]

    # -- phase 3: kernels against their plain versions ------------------------

    def kernel_checks(self) -> None:
        torch = self.torch
        gram, fused, apply = (self.kernels[k] for k in ("gram", "fused_apply_gram",
                                                       "apply_right"))
        cases = [  # (batch, m, n, k): ragged m, P = 8 batches, k != n
            (1, 1000, 32, 32), (P, 777, 128, 128), (2, 513, 256, 256),
            (3, 100, 7, 5), (2, 300, 64, 40), (1, 257, 512, 512),
            *[(b, m, n, n) for b, m, n in MAIN_SHAPES.values()],
        ]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            for seed, (b, m, n, k) in enumerate(cases):
                a = self.randn((b, m, n), seed, dtype)
                w = (self.randn((b, n, k), 100 + seed) / n ** 0.5).to(dtype)
                g = gram(a)
                q = apply(a, w)
                qf, gf = fused(a, w)
                g_only = fused(a, w, want_q=False)
                g_unfused = gram(q)
                torch.cuda.synchronize()
                errs = {
                    "gram": self.rel_err(g, self.ref.gram(a)),
                    "apply_right": self.rel_err(q, self.ref.apply_right(a, w)),
                    "fused_apply_gram": max(
                        self.rel_err(gf, self.ref.fused_apply_gram(a, w)[1]),
                        self.rel_err(qf, self.ref.apply_right(a, w)),
                    ),
                }
                bitwise = {
                    "fused Q == apply_right": torch.equal(qf, q),
                    "fused G == gram(apply_right)": torch.equal(gf, g_unfused),
                    "want_q=False == want_q=True": torch.equal(g_only, gf),
                    "gram rerun": torch.equal(gram(a), g),
                    "fused rerun": torch.equal(fused(a, w, want_q=False), g_only),
                    "apply_right rerun": torch.equal(apply(a, w), q),
                }
                torch.cuda.synchronize()
                log(f"[kernels] {dname} {(b, m, n, k)} rel err "
                    + " ".join(f"{k_}={v:.2e}" for k_, v in errs.items())
                    + f" bitwise {all(bitwise.values())}")
                for name, err in errs.items():
                    check(err <= TOL[dname], f"{name} {dname} {(b, m, n, k)}: rel err {err:.3e}"
                          f" > {TOL[dname]}")
                for what, ok in bitwise.items():
                    check(ok, f"{what} fails at {dname} {(b, m, n, k)}")
                if dtype == torch.float32 and (b, m, n, k) in {
                        (*shape, shape[-1]) for shape in MAIN_SHAPES.values()}:
                    self.float64_errors(a, w, g, q, gf)
                if dtype == torch.float32 and (b, m, n) == MAIN_SHAPES[HEADLINE]:
                    self.errors = {name: self._abs_err(name, a, w) for name in errs}

    def float64_errors(self, a, w, g, q, gf) -> None:
        """Kernel and plain version, each against a float64 product: which
        of the two f32 summation orders is nearer the exact value.  The
        kernel must stay within ``F64_TOL`` (full f32, no TF32)."""
        a64, w64, q64 = a.double(), w.double(), q.double()
        want = {"gram": a64.mT @ a64, "apply_right": a64 @ w64,
                "fused_apply_gram": q64.mT @ q64}
        got = {"gram": (g, self.ref.gram(a)), "apply_right": (q, self.ref.apply_right(a, w)),
               "fused_apply_gram": (gf, self.ref.gram(q))}
        errs = {name: [self.rel_err(x.double(), want[name]) for x in pair]
                for name, pair in got.items()}
        log(f"[kernels] vs float64 at {tuple(a.shape)}: " + "; ".join(
            f"{name} kernel {k:.2e} plain {p:.2e}" for name, (k, p) in errs.items()))
        for name, (err, _) in errs.items():
            check(err <= F64_TOL, f"{name} at {tuple(a.shape)}: {err:.3e} from float64 "
                  f"> {F64_TOL}")

    def _abs_err(self, name: str, a, w) -> float:
        """max |kernel − plain| on the headline main-path inputs."""
        kern, ref = self.kernels[name], self.ref
        if name == "gram":
            return (kern(a) - ref.gram(a)).abs().max().item()
        if name == "apply_right":
            return (kern(a, w) - ref.apply_right(a, w)).abs().max().item()
        return (kern(a, w, want_q=False) - ref.fused_apply_gram(a, w)[1]).abs().max().item()

    # -- phase 4: the main path -----------------------------------------------

    def main_path(self) -> None:
        torch = self.torch
        from repro_torch.collective import FaultSpec
        from repro_torch.qr import QRConfig, factorize

        counts = self.dispatch.launches
        fault = FaultSpec.of({5: 1})
        runs = [(name, v, f, False) for name in ("paper_fig",) for v in VARIANTS
                for f in (None, fault)]
        runs += [(HEADLINE, v, f, False) for v in ("redundant", "selfhealing")
                 for f in (None, fault)]
        runs += [("paper_fig", "redundant", None, True)]
        data = {name: self.randn(shape, 1000 + i) for i, (name, shape) in
                enumerate(MAIN_SHAPES.items())}
        truth = {}
        for name, a in data.items():
            r64 = torch.linalg.qr(a.reshape(-1, a.shape[-1]).double(), mode="r")[1]
            truth[name] = r64 * torch.where(r64.diagonal() < 0, -1.0, 1.0).double()[:, None]
        torch.cuda.synchronize()

        counts.reset()
        for name, variant, faults, want_q in runs:
            before = counts.as_dict()
            res = factorize(data[name], QRConfig(variant=variant, local_r="cqr2_pallas",
                                                 compute_q=want_q), faults=faults)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in counts.as_dict().items()}
            deaths = faults.deaths if faults else ()
            tag = f"{name} {tuple(data[name].shape)} {variant} faults={deaths}"
            # one launch of each for all P ranks; with compute_q the
            # reorthogonalization pass adds one gram launch
            want = {"gram": 1 + want_q, "fused_apply_gram": 1, "apply_right": 0}
            check(delta == want, f"{tag}: launches {delta}, want {want}")
            valid = res.valid.cpu().numpy()
            check((valid == res.plan.final_valid).all(),
                  f"{tag}: validity {valid} != plan {res.plan.final_valid}")
            t = truth[name]
            err = max(((res.r[i].double() - t).abs().max() / t.abs().max()).item()
                      for i in valid.nonzero()[0].tolist())
            check(err <= R_TIGHT, f"{tag}: survivor R rel err {err:.3e} > {R_TIGHT} "
                  f"(suite limit {R_TOL})")
            line = f"[main] {tag} valid={valid.astype(int).tolist()} R rel err {err:.2e}"
            if want_q:
                q = res.q.double()
                ortho = (torch.einsum("pmi,pmj->ij", q, q)
                         - torch.eye(q.shape[-1], dtype=torch.float64, device="cuda")
                         ).abs().max().item()
                check(ortho <= ORTHO_TOL, f"{tag}: ||QᵀQ − I|| {ortho:.3e} > {ORTHO_TOL}")
                line += f" ||QᵀQ−I||={ortho:.2e}"
            log(line + f" launches {delta}")

        self.launches["factorize"] = counts.as_dict()
        log(f"[main] launches over {len(runs)} factorizations: {self.launches['factorize']}")

        # the kernel layer's explicit-Q CholeskyQR2 (sweep 3 is apply_right),
        # held against the R-only path as the reference's kernels bench case
        # does; its launches are counted on their own
        counts.reset()
        for name, a in data.items():
            before = counts.as_dict()
            q, r = self.ops.cholesky_qr2(a, use_pallas=True)
            r_only = self.ops.cholesky_qr2_r(a, use_pallas=True)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in counts.as_dict().items()}
            check(delta == {"gram": 2, "fused_apply_gram": 2, "apply_right": 1},
                  f"cholesky_qr2 {name}: launches {delta}")
            check(torch.equal(r, r_only), f"cholesky_qr2 {name}: R-only != full-Q R")
            q64 = q.double()
            ortho = (q64.mT @ q64 - torch.eye(q.shape[-1], dtype=torch.float64,
                                              device="cuda")).abs().max().item()
            check(ortho <= 3e-5, f"cholesky_qr2 {name}: per-rank ||QᵀQ − I|| {ortho:.3e}")
            log(f"[main] cholesky_qr2 {name} {tuple(a.shape)} R-only == full-Q R, "
                f"per-rank ||QᵀQ−I||={ortho:.2e} launches {delta}")
        self.launches["cholesky_qr2"] = counts.as_dict()
        log(f"[main] launches over {len(data)} explicit-Q cholesky_qr2 calls: "
            f"{self.launches['cholesky_qr2']}")
        for kernel, path in KERNEL_PATH.items():
            check(self.launches[path][kernel] > 0, f"{kernel} was never launched on its "
                  f"path ({path})")

        self.profile(data, QRConfig, factorize)

        # end-to-end factorize times
        for name, variant, faults, want_q in runs:
            cfg = QRConfig(variant=variant, local_r="cqr2_pallas", compute_q=want_q)
            samples = []
            for i in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                factorize(data[name], cfg, faults=faults)
                torch.cuda.synchronize()
                if i:
                    samples.append((time.perf_counter() - t0) * 1e3)
            log(f"[e2e] factorize {name} {tuple(data[name].shape)} {variant} "
                f"faults={faults.deaths if faults else ()} compute_q={want_q}: "
                f"median {statistics.median(samples):.3f} ms "
                f"(min {min(samples):.3f}, max {max(samples):.3f}, 5 runs)")

    def profile(self, data, qr_config, factorize) -> None:
        """Where one fault-free redundant factorization spends device time:
        ``torch.profiler`` over one warm call per main-path shape, the
        device-time sums by kernel, and the device's busy share of the
        wall time (kernel self time summed over the call's wall clock; the
        call runs alone on the card, so kernels do not overlap)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        cfg = qr_config(variant="redundant", local_r="cqr2_pallas")
        for name, a in data.items():
            factorize(a, cfg)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                factorize(a, cfg)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            # device activities only: an aten:: operator's device time repeats
            # the time of the kernels it launched
            rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                    if e.self_device_time_total > 0 and not e.key.startswith("aten::")]
            busy_us = sum(t for _, t, _ in rows)
            if not rows:
                log(f"[profile] {name}: the profiler recorded no device time (not measured)")
                continue
            log(f"[profile] {name} {tuple(a.shape)}: wall {wall_us:.0f} us, device busy "
                f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%)")
            for key, t, count in sorted(rows, key=lambda r: -r[1])[:8]:
                log(f"[profile]   {t:10.0f} us  x{count:<4d} {key[:90]}")

    # -- phase 5: kernel times ------------------------------------------------

    def timings(self) -> None:
        torch = self.torch
        ref = self.ref
        for shape_name, (b, m, n) in MAIN_SHAPES.items():
            a = self.randn((b, m, n), 2000)
            w = self.randn((b, n, n), 2001) / n ** 0.5
            f32 = 4
            # Operations the function needs: a Gram is symmetric, so its
            # n(n+1)/2 distinct entries of 2m operations each; the fused
            # sweep is the product (2mnk) and the Gram of its (m, k) result.
            gram_ops = b * m * n * (n + 1)
            product_ops = 2 * b * m * n * n
            work = {
                "gram": (f32 * b * (m * n + n * n), gram_ops,
                         lambda: self.kernels["gram"](a), lambda: ref.gram(a),
                         lambda: torch.matmul(a.mT, a)),
                "fused_apply_gram": (f32 * b * (m * n + 2 * n * n), product_ops + gram_ops,
                                     lambda: self.kernels["fused_apply_gram"](a, w,
                                                                              want_q=False),
                                     lambda: ref.fused_apply_gram(a, w)[1],
                                     lambda: torch.einsum("bmi,bij,bmk,bkl->bjl", a, w, a, w)),
                "apply_right": (f32 * b * (2 * m * n + n * n), product_ops,
                                lambda: self.kernels["apply_right"](a, w),
                                lambda: ref.apply_right(a, w), lambda: torch.matmul(a, w)),
            }
            # one library call for the fused sweep: an einsum of (A, W, A, W)
            # gives Wᵀ(AᵀA)W = (AW)ᵀ(AW), equal in f32 to G' of the cast Q
            lib_err = self.rel_err(work["fused_apply_gram"][4](), ref.fused_apply_gram(a, w)[1])
            check(lib_err <= TOL["float32"], f"einsum yardstick {shape_name}: {lib_err:.3e}")
            for name, (nbytes, flops, kern, plain, lib) in work.items():
                bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
                row = {
                    "shape": [b, m, n, n],
                    "ms": self.time_ms(kern),
                    "plain_ms": self.time_ms(plain),
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "library_ms": self.time_ms(lib) if lib else None,
                }
                self.times[(name, shape_name)] = row
                log(f"[time] {name} {shape_name} {json.dumps(row)}")

    def kernel_rows(self) -> list[dict]:
        rows = []
        for name in self.kernels:
            t = self.times[(name, HEADLINE)]
            rows.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": REPLACES[name],
                "launches": self.launches[KERNEL_PATH[name]][name],
                "path": KERNEL_PATH[name],
                "launches_by_path": {path: counts[name]
                                     for path, counts in self.launches.items()},
                "max_abs_err": self.errors[name],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": t["shape"],
            })
        return rows


if __name__ == "__main__":
    sys.exit(main())
