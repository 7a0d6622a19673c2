"""Training launcher — the port of the reference's :mod:`repro.launch.train`,
with its flags and output lines, on the card unless ``--device`` names
another.

Smoke-scale by default (the reduced config, one replica); ``--full`` trains
the published config, ``--mesh dx1`` over d replicas simulated on the one
device::

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --mesh 4x1 --on-failure rebuild --fail "10:0" --straggle "20:1:3"
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --device cpu

``--faults <name>`` replays a stock trainer scenario from
:mod:`repro_torch.bench.scenarios` (event schedule, mesh width, recovery
policy and expected fault-stat counts) against any ``--arch`` /
``--optimizer``, exiting non-zero when the run's fault stats miss the
scenario's expectations::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
      --optimizer powersgd --faults shrink_then_rebuild

``--mesh single|multi`` (the reference's production TPU meshes) and a model
axis wider than 1 are tensor-parallel layouts, which wait for the model
axis over DistComm (ROADMAP A.3e).
"""
from __future__ import annotations

import argparse
import os
import tempfile


def parse_events(fail: str, straggle: str, recover: str):
    from repro_torch.runtime.trainer import FaultEvent

    events = []
    for spec, kind in ((fail, "fail"), (recover, "recover")):
        for item in filter(None, spec.split(",")):
            step, rep = item.split(":")
            events.append(FaultEvent(step=int(step), kind=kind, replica=int(rep)))
    for item in filter(None, straggle.split(",")):
        parts = item.split(":")
        step, rep = int(parts[0]), int(parts[1])
        dur = int(parts[2]) if len(parts) > 2 else 1
        events.append(FaultEvent(step=step, kind="straggle", replica=rep, duration=dur))
    return tuple(events)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="full published config")
    ap.add_argument("--mesh", default="auto",
                    help="auto (one replica) | dx1 (e.g. 4x1: d replicas on the device)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--on-failure", default="blank",
                    choices=["blank", "shrink", "rebuild"])
    ap.add_argument("--optimizer", default=None,
                    choices=["adamw", "powersgd", "orthosgd", "lowrank"],
                    help="default adamw (or the --faults scenario's choice)")
    ap.add_argument("--faults", default="",
                    help="stock trainer scenario name from "
                         "repro_torch.bench.scenarios (overrides the event "
                         "schedule, mesh width, and recovery policy)")
    ap.add_argument("--fail", default="", help="step:replica[,...]")
    ap.add_argument("--recover", default="", help="step:replica[,...]")
    ap.add_argument("--straggle", default="", help="step:replica[:dur][,...]")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"),
                    help="default: repro_ckpt under the temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def stock_scenario(name: str):
    """The stock trainer scenario called ``name``; SystemExit naming the
    others when there is none."""
    from repro_torch.bench.scenarios import get_scenarios

    stock = {s.name: s for s in get_scenarios() if s.kind == "trainer"}
    if name not in stock:
        raise SystemExit(
            f"unknown --faults scenario {name!r}; trainer "
            "scenarios: " + ", ".join(sorted(stock))
        )
    return stock[name]


def make_mesh(spec: str, sc=None):
    """The replica mesh of ``--mesh`` (or of the scenario ``sc``)."""
    from repro_torch.runtime.elastic import ReplicaMesh

    if sc is not None:
        return ReplicaMesh.of((sc.data_width, sc.model_width), ("data", "model"))
    if spec in ("single", "multi"):
        raise NotImplementedError(
            f"--mesh {spec} is a production TPU mesh (data x model over many devices), "
            "which waits for the model axis over DistComm (ROADMAP A.3e); use --mesh dx1"
        )
    if spec == "auto":
        return ReplicaMesh.of((1, 1), ("data", "model"))
    d, m = (int(x) for x in spec.split("x"))
    return ReplicaMesh.of((d, m), ("data", "model"))


def build_trainer(args):
    """The launcher's Trainer and scenario (or None) for parsed ``args``."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    sc = stock_scenario(args.faults) if args.faults else None
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    mesh = make_mesh(args.mesh, sc)
    tcfg = TrainerConfig(
        steps=sc.steps if sc is not None else args.steps,
        microbatches=args.microbatches,
        on_failure=sc.on_failure if sc is not None else args.on_failure,
        optimizer=args.optimizer or (sc.optimizer if sc is not None
                                     else "adamw"),
        ckpt_dir=args.ckpt_dir,
        ckpt_every=sc.ckpt_every if sc is not None else args.ckpt_every,
        buddy_levels=sc.buddy_levels if sc is not None else 1,
        lr=args.lr,
    )
    dcfg = DataConfig(
        vocab=cfg.vocab,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        family=cfg.family,
        enc_frames=cfg.enc_frames if cfg.family == "encdec" else 0,
        d_model=cfg.d_model,
    )
    return Trainer(cfg, tcfg, mesh, dcfg, device=args.device), sc


def run(args):
    """Train as the launcher does and print its lines; returns the
    trainer.  Raises SystemExit when a ``--faults`` scenario's fault stats
    miss its expectations."""
    trainer, sc = build_trainer(args)
    schedule = (tuple(sc.events) if sc is not None
                else parse_events(args.fail, args.straggle, args.recover))
    trainer.run(fault_schedule=schedule)      # from the trainer's own init_state()
    print("\n".join(trainer.events_log))
    print(f"final loss: {trainer.metrics_log[-1]['loss']:.4f}")
    if sc is not None:
        stats = {k: int(v) for k, v in trainer.fault_stats.items() if v}
        print(f"fault stats: {stats}")
        missed = {k: (int(trainer.fault_stats[k]), want)
                  for k, want in sc.expect.items()
                  if int(trainer.fault_stats[k]) != want}
        if missed:
            raise SystemExit(
                f"scenario {sc.name}: fault stats missed expectations "
                f"(got, want) = {missed}"
            )
        print(f"scenario {sc.name}: fault stats match expectations")
    return trainer


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
