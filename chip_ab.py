#!/usr/bin/env python3
"""Time two or more checkouts of the PyTorch/CUDA port in turns on one GPU.

    python3 chip_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (a directory holding
``src/repro_torch``).  In the order given, one process per argument builds
that checkout's kernels (into its own ``build/``), draws the same inputs
from fixed seeds on the card and times, with TF32 off:

* the kernels (CUDA events, median of 7 samples of 5 launches):
  ``gram`` at 8 × 2^19 × 128, 8 × 2^17 × 128, 8 × 2^17 × 32 and
  8 × 2^17 × 512; ``panel_cross`` at 8 × 2^17 × 512, split 128;
  ``pad_cross`` at 8 × 2^17 × 480 widened to 512, split 128;
  ``apply_right`` at 8 × 2^19 × 128; ``trailing_update`` on the strided
  8 × 2^17 × 384 trailing block of general_full with the 128-column
  lookahead; ``fused_apply_gram`` at 8 × 2^19 × 128 with ``want_q`` False
  and True; ``combine_gram`` at 8 × n × n, n = 32, 128 and 512, f32 and
  bf16;
* blocked ``factorize`` at general_full (8 × 2^17 × 512, panels of 128,
  ``use_pallas``) through the pipeline and the eager driver and at
  general_ragged (8 × 2^17 × 480) through the pipeline, the kernel layer's
  explicit-Q ``ops.cholesky_qr2``, TSQR ``factorize`` (redundant
  butterfly, ``local_r="cqr2_pallas"``) at powersgd_panel (8 × 2^19 ×
  128) and the batched TSQR of 4 × 8 × 2^17 × 32: host clock around calls
  ending in a synchronize, median of 5 warm runs.  Where a checkout
  replays its cached programs as CUDA graphs, the pipeline and the batched
  TSQR are replays there.

Each process also prints a SHA-256 of the bytes of every output of each
kernel it times (G; S and A_pad; Q; A_new and S; G′; combine_gram's G) and
of each call's R, all from the fixed seeds, so checkouts whose kernels keep the same bits
print the same hashes.  Each process prints one JSON line; the last line
is a JSON object with every run's numbers in the order given, whether the
hashes of all runs agree (and which differ), and the card's name and
power limit.  Comparing versions in one call on one card, in turns (old,
new, new, old), keeps the card and its neighbours the same.
"""
from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

P = 8
PANEL = 128
GENERAL_FULL = (P, 1 << 17, 512)
GENERAL_RAGGED = (P, 1 << 17, 480)
POWERSGD_PANEL = (P, (1 << 22) // P, 128)


def _events_ms(torch, fn, repeats: int = 7, inner: int = 5) -> float:
    for _ in range(2):
        fn()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def _host_ms(torch, fn) -> float:
    samples = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def _sha256(*tensors) -> str:
    """SHA-256 of the tensors' bytes in order (f32 or bf16, read raw)."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        raw = t.detach().contiguous().view(-1).view(torch.uint8)
        for chunk in raw.split(1 << 28):
            h.update(chunk.cpu().numpy().tobytes())
    return h.hexdigest()


def one(root: Path) -> dict:
    """Build and time one checkout in this process."""
    import torch

    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.apply_right import apply_right
    from repro_torch.kernels.combine_gram import combine_gram
    from repro_torch.kernels.fused_apply_gram import fused_apply_gram
    from repro_torch.kernels.gram import gram
    from repro_torch.kernels.trailing_update import pad_cross, panel_cross, trailing_update
    from repro_torch.qr import QRConfig, factorize

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    gen = torch.Generator(device="cuda")

    def randn(shape, seed, dtype=torch.float32):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    full = randn(GENERAL_FULL, 4000)
    ragged = randn(GENERAL_RAGGED, 4001)
    a = randn(POWERSGD_PANEL, 2000)
    w = randn(POWERSGD_PANEL[:1] + POWERSGD_PANEL[2:] * 2, 2001) / POWERSGD_PANEL[2] ** 0.5
    polish = randn((P, 1 << 17, PANEL), 2002)
    narrow = randn((P, 1 << 17, 32), 2003)
    trail = full[..., PANEL:]                     # the strided trailing block, n_t = 384
    q = randn(GENERAL_FULL[:2] + (PANEL,), 4002) / GENERAL_FULL[1] ** 0.5
    wt = randn((P, PANEL, trail.shape[-1]), 4003) / PANEL ** 0.5
    kernels = {
        "gram": lambda: gram(a),
        "gram_polish": lambda: gram(polish),
        "gram_n32": lambda: gram(narrow),
        "gram_n512": lambda: gram(full),
        "panel_cross": lambda: panel_cross(full, split=PANEL),
        "pad_cross": lambda: pad_cross(ragged, split=PANEL, out_width=GENERAL_FULL[2]),
        "apply_right": lambda: apply_right(a, w),
        "trailing_update": lambda: trailing_update(trail, q, wt, next_width=PANEL),
        "fused_apply_gram": lambda: fused_apply_gram(a, w, want_q=False),
        "fused_apply_gram_want_q": lambda: fused_apply_gram(a, w),
    }
    for dtype in (torch.float32, torch.bfloat16):
        for n in (32, 128, 512):
            r1, r2 = (randn((P, n, n), 700 + n + i, dtype) for i in (0, 1))
            name = f"combine_gram_n{n}_{str(dtype).removeprefix('torch.')}"
            kernels[name] = lambda r1=r1, r2=r2: combine_gram(r1, r2)
    out = {"root": str(root)}
    hashes = {}
    for name, fn in kernels.items():
        out[f"{name}_ms"] = _events_ms(torch, fn)
        res = fn()
        hashes[name] = _sha256(*(res if isinstance(res, tuple) else (res,)))
        del res
    calls = {}
    for pipeline in ("auto", "off"):
        cfg = QRConfig(panel_width=PANEL, use_pallas=True, pipeline=pipeline)
        calls[f"blocked_general_full_pipeline_{pipeline}"] = lambda cfg=cfg: factorize(full, cfg)
    ragged_cfg = QRConfig(panel_width=PANEL, use_pallas=True, pipeline="auto")
    calls["blocked_general_ragged_pipeline_auto"] = lambda: factorize(ragged, ragged_cfg)
    calls["cholesky_qr2_powersgd_panel"] = lambda: ops.cholesky_qr2(a, use_pallas=True)
    tsqr = QRConfig(variant="redundant", local_r="cqr2_pallas")
    calls["tsqr_powersgd_panel"] = lambda: factorize(a, tsqr)
    stack = randn((4, P, 1 << 17, 32), 2004)
    calls["tsqr_batched_4x_paper_fig"] = lambda: factorize(stack, tsqr)
    for name, fn in calls.items():
        out[f"{name}_ms"] = _host_ms(torch, fn)
        res = fn()
        hashes[name] = _sha256(*(res if isinstance(res, tuple) else (res.r,)))
        del res
    out["sha256"] = hashes
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    runs = []
    for root in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    differ = sorted({k for run in runs for k, h in run["sha256"].items()
                     if h != runs[0]["sha256"].get(k)})
    print(card)
    print(json.dumps({"card": card, "hashes_agree": not differ, "hashes_differ": differ,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
