"""``python -m repro_torch.bench`` — run / compare / list (the port of
:mod:`repro.bench.__main__`).

``run`` runs the registered cases on the card (``--device cpu`` for the
CPU) and writes ``results/bench_torch/BENCH_<timestamp>.json``.  It forces
no device count: the port's ranks and replicas are simulated on one
device.  ``compare`` and ``list`` touch no device.
"""
from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def _cmd_run(args) -> int:
    from . import cases  # noqa: F401  — registers the benchmark cases
    from . import runner

    doc = runner.run_cases(args.tier, only=tuple(args.only) or None, device=args.device)
    path = runner.write_doc(doc, out=args.out, out_dir=args.out_dir)
    bad = {n: c for n, c in doc["cases"].items() if c["status"] == "error"}
    print(f"[bench] wrote {path}")
    if bad:
        for n, c in bad.items():
            print(f"[bench] case {n} errored: {c['error']}", file=sys.stderr)
        return 1
    return 0


def _cmd_compare(args) -> int:
    from . import compare

    cmp = compare.compare_files(
        args.baseline, args.new,
        tolerance=args.tolerance, timing_tolerance=args.timing_tolerance,
    )
    print(cmp.report())
    return cmp.exit_code(strict_timing=args.strict_timing)


def _cmd_list(args) -> int:
    from . import cases  # noqa: F401
    from .registry import REGISTRY

    for c in sorted(REGISTRY.values(), key=lambda c: c.name):
        tags = f" [{','.join(c.tags)}]" if c.tags else ""
        print(f"{c.name:<18} tiers={','.join(c.tiers)}{tags}")
    return 0


def main(argv: list[str] | None = None) -> int:
    from .runner import DEFAULT_OUT_DIR

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench",
        description="machine-readable benchmarks + fault-scenario sweeps on the port",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="run registered cases, write BENCH_*.json")
    rp.add_argument("--tier", default="smoke", choices=("smoke", "full"))
    rp.add_argument("--only", nargs="*", default=(), help="run only these case names")
    rp.add_argument("--out", default=None, help="explicit output path (default: timestamped)")
    rp.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    rp.add_argument("--device", default=None, help="cpu for the CPU (default: the card)")
    rp.set_defaults(fn=_cmd_run)

    cp = sub.add_parser("compare", help="gate a new run against a baseline")
    cp.add_argument("baseline")
    cp.add_argument("new")
    cp.add_argument("--tolerance", type=float, default=0.05,
                    help="relative tolerance for hard metrics")
    cp.add_argument("--timing-tolerance", type=float, default=0.50,
                    help="relative tolerance for warn (timing) metrics")
    cp.add_argument("--strict-timing", action="store_true",
                    help="promote timing warnings to failures")
    cp.set_defaults(fn=_cmd_compare)

    lp = sub.add_parser("list", help="list registered cases")
    lp.set_defaults(fn=_cmd_list)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
