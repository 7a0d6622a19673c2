"""Shared cases of the mesh-route parity tests (``test_torch_dist.py`` and
``test_torch_dist_qr.py``): the cases of the reference's own SPMD tests
(``tests/test_spmd.py``), computed once per test session on each side
(:func:`both_sides`).

* The port runs them in one world of :data:`P` CPU ranks
  (:func:`repro_torch.collective.dist.run_ranks`): :func:`port_cases` is
  the rank function, returning this rank's outputs as numpy arrays, bools,
  strings and dicts.  This module imports neither JAX nor the port at
  import time, so the spawned ranks load only torch.
* The reference runs them under ``shard_map`` over :data:`P` forced host
  devices in two subprocesses, one a part (this module run as a script
  with ``XLA_FLAGS`` set), and returns its global outputs.

Both sides draw the same numpy inputs and make the same calls in the same
order in a fresh process, so the process-lifetime ``kernel:<op>`` traces
of the tracked calls are the same.
"""
from __future__ import annotations

import fcntl
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

P = 8
OPS = ("sum", "mean", "max", "gram_sum")
VARIANTS = ("tree", "redundant", "replace", "selfhealing")
FAULTED = ("redundant", "replace", "selfhealing")
DEATHS = {5: 1, 2: 2}                                # tests/test_spmd.py:248
QR_SPECS = ({5: 1}, {5: 1, 2: 2}, {1: 1, 4: 2, 6: 2})   # tests/test_spmd.py:47
FAST_OPS = ("sum", "max", "gram_sum", "qr")
COUNTED = (("sum", "redundant", None), ("sum", "replace", DEATHS),
           ("gram_sum", "selfhealing", DEATHS), ("mean", "tree", None))
SCHEDULE = dict(panel={1: {2: 1}}, update={2: {5: 1}})  # tests/test_spmd.py:97


def _key(deaths) -> str:
    return "none" if not deaths else str(sorted(deaths.items()))


def allreduce_inputs() -> dict[str, np.ndarray]:
    """The payloads of ``tests/test_spmd.py:212`` and ``:281`` (the Gram
    payloads are made in numpy, so both sides get the same bits)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(P, 4, 5)).astype(np.float32)
    sym = np.einsum("pmi,pmj->pij", x, x)
    tall = rng.normal(size=(P, 12, 4)).astype(np.float32)
    rng = np.random.default_rng(11)
    xj = rng.normal(size=(P, 6, 5)).astype(np.float32)
    symj = np.einsum("pmi,pmj->pij", xj, xj)
    return {"x": x, "sym": sym, "tall": tall, "xj": xj, "symj": symj}


def qr_inputs(ref) -> dict[str, np.ndarray]:
    """The matrices of ``tests/test_spmd.py:29`` (TSQR) and ``:67``
    (blocked QR), and a wider one for the Gram butterfly and the kernel
    route; each (P, m_local, n), rank r's block being ``[r]``.  ``ref`` is
    either side's numpy oracle module (the port's is a copy)."""
    return {
        "tsqr": ref.random_tall_skinny(np.random.default_rng(1), P, 16, 4),
        "blocked": np.random.default_rng(3).standard_normal((P, 24, 15)).astype(np.float32),
        "wide": ref.random_tall_skinny(np.random.default_rng(5), P, 32, 6),
    }


# ---------------------------------------------------------------------------
# The port's side: rank functions
# ---------------------------------------------------------------------------

def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _tracked(fn):
    """``fn()`` under the dispatch and traffic trackers: (result,
    dispatch dict, traffic dict)."""
    from repro_torch.kernels import dispatch as disp
    from repro_torch.kernels import traffic

    with disp.track_dispatch() as d, traffic.track_traffic() as t:
        out = fn()
    return out, d.as_dict(), t.as_dict()


def port_allreduce(mesh) -> dict:
    """This rank's outputs of the all-reduce cases."""
    import torch

    from repro_torch.collective import (
        DistComm,
        FaultSpec,
        InstrumentedComm,
        SimComm,
        execute_plan,
        ft_allreduce,
        ft_allreduce_jit,
        make_plan,
    )
    from repro_torch.collective.dist import RankMesh
    from repro_torch.kernels import dispatch as disp

    r = mesh.rank
    comm = DistComm(P, "rows")
    ins = allreduce_inputs()

    def mine(name):
        return torch.from_numpy(ins[name][r])

    out: dict = {"rank": r}
    # the raw exchange: ranks 1 and 3 receive, the others get zeros; an
    # empty perm sends nothing
    pair = (mine("x"), torch.tensor(r % 2 == 0))
    got = comm.exchange(pair, ((0, 1), (2, 3)))
    empty = comm.exchange(pair, ())
    out["exchange"] = (_np(got[0]), bool(got[1]), _np(empty[0]), bool(empty[1]))
    for deaths in (None, DEATHS):
        for op in OPS:
            for variant in (VARIANTS if deaths is None else FAULTED):
                fs = FaultSpec.of(deaths) if deaths else None
                v, ok = ft_allreduce(mine("x"), comm, op=op, variant=variant, fault_spec=fs)
                out[("ar", op, variant, _key(deaths))] = (_np(v), bool(ok))
    for op in FAST_OPS:
        payload = mine("tall" if op == "qr" else "sym")
        for variant in VARIANTS:
            plan = make_plan(variant, P)
            va, oa = execute_plan(payload, comm, plan, op)
            vg, og = execute_plan(payload, comm, plan, op, fast=False)
            out[("fast", op, variant)] = (_np(va), bool(oa), _np(vg), bool(og),
                                          plan.is_fault_free)
    for op, variant, deaths in COUNTED:
        ic = InstrumentedComm(comm)
        ft_allreduce(mine("sym" if op == "gram_sum" else "x"), ic, op=op, variant=variant,
                     fault_spec=FaultSpec.of(deaths) if deaths else None)
        out[("count", op, variant, _key(deaths))] = ic.stats.as_dict()
    # ft_allreduce_jit on the mesh against the SimComm program (:281)
    sim = SimComm(P, "cpu")
    for op, name in (("sum", "xj"), ("gram_sum", "symj")):
        (vm, okm), d, _ = _tracked(lambda: ft_allreduce_jit(
            torch.from_numpy(ins[name][r:r + 1]), comm, op=op, mesh=mesh))
        vs, oks = ft_allreduce_jit(torch.from_numpy(ins[name]), sim, op=op)
        out[("jit", op)] = (_np(vm), _np(okm), _np(vs[r:r + 1]), _np(oks[r:r + 1]), d)
    plan = make_plan("redundant", P, FaultSpec.of(DEATHS))
    xj = torch.from_numpy(ins["xj"][r:r + 1])
    vm, okm = ft_allreduce_jit(xj, comm, op="sum", plan=plan, mesh=mesh)
    vs, oks = ft_allreduce_jit(torch.from_numpy(ins["xj"]), sim, op="sum", plan=plan)
    out["jit_faulted"] = (_np(vm), _np(okm), _np(vs[r:r + 1]), _np(oks[r:r + 1]))
    before = disp.trace_count("ft_allreduce")
    _, d, _ = _tracked(lambda: ft_allreduce_jit(xj, comm, op="sum", plan=plan, mesh=mesh))
    out["jit_warm"] = (disp.trace_count("ft_allreduce") - before, d)
    errors = {}
    for name, bad in (("no_mesh", None),
                      ("size", RankMesh(("rows",), (0, 1, 2, 3), mesh.device)),
                      ("axis", RankMesh(("x",), mesh.members, mesh.device))):
        try:
            ft_allreduce_jit(xj, comm, op="sum", mesh=bad)
        except ValueError as e:
            errors[name] = str(e)
    out["jit_errors"] = errors
    return out


def port_qr(mesh) -> dict:
    """This rank's outputs of the QR cases."""
    import torch

    from repro_torch.collective import FaultSpec, SimComm
    from repro_torch.qr import (
        PanelFaultSchedule,
        QRConfig,
        blocked_qr_shard_map,
        factorize,
        tsqr_gram_shard_map,
        tsqr_shard_map,
    )
    from repro_torch.qr.tsqr import gram_tsqr

    from repro_torch.core import ref

    r = mesh.rank
    ins = qr_inputs(ref)
    a, b, w = ins["tsqr"][r], ins["blocked"][r], ins["wide"][r]
    out: dict = {"rank": r}

    def tsqr_row(res):
        return (_np(res.r), _np(res.valid), res.plan.final_valid, res.plan.message_count())

    # -- TSQR (tests/test_spmd.py:29), the tracked calls first ---------------
    res, d, t = _tracked(lambda: tsqr_shard_map(a, mesh=mesh, axis="rows", variant="tree"))
    out["tsqr_first"] = (d, t)
    _, d, t = _tracked(lambda: tsqr_shard_map(a, mesh=mesh, axis="rows", variant="tree"))
    out["tsqr_warm"] = (d, t)
    for v in VARIANTS:
        out[("tsqr", v, "none")] = tsqr_row(tsqr_shard_map(a, mesh=mesh, axis="rows", variant=v))
    for deaths in QR_SPECS:
        for v in FAULTED:
            res = factorize(a, QRConfig(variant=v), faults=FaultSpec.of(deaths), mesh=mesh)
            out[("tsqr", v, _key(deaths))] = tsqr_row(res)
    res = tsqr_shard_map(a, mesh=mesh, axis="rows", variant="redundant", compute_q=True)
    out["tsqr_q"] = (_np(res.r), _np(res.q))
    # the kernel route (cqr2_pallas: the kernels' plain versions on the CPU)
    res, d, t = _tracked(lambda: factorize(w, QRConfig(local_r="cqr2_pallas", compute_q=True),
                                           mesh=mesh))
    out["tsqr_kernels"] = (_np(res.r), _np(res.q), d, t)
    # -- the Gram butterfly ---------------------------------------------------
    res, d, t = _tracked(lambda: factorize(w, QRConfig(gram=True), mesh=mesh))
    shim = tsqr_gram_shard_map(w, mesh=mesh, axis="rows")
    out["gram"] = (_np(res.r), _np(res.valid), _np(res.q), d, t, _np(shim.r), _np(shim.q),
                   res.plan.final_valid)
    # -- the blocked QR (tests/test_spmd.py:67) -------------------------------
    first = _tracked(lambda: blocked_qr_shard_map(b, mesh=mesh, axis="rows", panel_width=4,
                                                  compute_q=True))
    warm = _tracked(lambda: blocked_qr_shard_map(b, mesh=mesh, axis="rows", panel_width=4,
                                                 compute_q=True))
    res = first[0]
    out["blocked"] = (_np(res.r), _np(res.valid), _np(res.q), first[1:], warm[1:],
                      torch.equal(res.r, warm[0].r))
    sched = PanelFaultSchedule.of(**SCHEDULE)
    first = _tracked(lambda: blocked_qr_shard_map(b, mesh=mesh, axis="rows", panel_width=4,
                                                  variant="replace", faults=sched))
    warm = _tracked(lambda: factorize(b, QRConfig(panel_width=4, variant="replace"),
                                      faults=sched, mesh=mesh))
    res = first[0]
    out["blocked_faulted"] = (_np(res.r), _np(res.valid), first[1:], warm[1:],
                              _reports(res.reports))
    off = factorize(b, QRConfig(panel_width=4, variant="replace", recover="off"),
                    faults=sched, mesh=mesh)
    out["blocked_no_recovery"] = (_np(off.r), _np(off.valid), _reports(off.reports))
    # -- the same stacks on SimComm, for the in-port comparison ---------------
    sim = {}
    sim["tsqr"] = _np(factorize(ins["tsqr"], QRConfig(), device="cpu").r[r])
    sim["tsqr_q"] = _np(factorize(ins["tsqr"], QRConfig(compute_q=True), device="cpu").q[r])
    for deaths in QR_SPECS:
        res = factorize(ins["tsqr"], QRConfig(variant="replace"), faults=FaultSpec.of(deaths),
                        device="cpu")
        sim[("tsqr_replace", _key(deaths))] = _np(res.r[r])
    rg, qg = gram_tsqr(torch.from_numpy(ins["wide"]), SimComm(P, "cpu"))
    sim["gram"] = (_np(rg[r]), _np(qg[r]))
    res = factorize(ins["blocked"], QRConfig(panel_width=4, compute_q=True), device="cpu")
    sim["blocked"] = (_np(res.r[r]), _np(res.q[r]))
    res = factorize(ins["blocked"], QRConfig(panel_width=4, variant="replace"),
                    faults=PanelFaultSchedule.of(**SCHEDULE), device="cpu")
    sim["blocked_faulted"] = _np(res.r[r])
    out["sim"] = sim
    return out


def _reports(reports) -> list[tuple]:
    """A blocked run's reports as plain values (plans by their final
    validity and message count)."""
    rows = []
    for rep in reports:
        rows.append((rep.panel, rep.plan_r.final_valid.tolist(), rep.plan_r.message_count(),
                     None if rep.plan_w is None else rep.plan_w.final_valid.tolist(),
                     rep.within_tolerance_r, rep.within_tolerance_w, rep.recovered_r,
                     rep.recovered_w, rep.recoverable, rep.fused))
    return rows


def gather(per_rank: list, pick) -> np.ndarray:
    """The ranks' values of one output, concatenated in rank order (each
    is a (1, …) slice, or a local block concatenated along rows)."""
    return np.concatenate([pick(out) for out in per_rank], axis=0)


# ---------------------------------------------------------------------------
# The reference's side (run in a subprocess with P forced host devices)
# ---------------------------------------------------------------------------

def port_cases(mesh) -> dict:
    """This rank's outputs of every case: the all-reduce's, then the QR's."""
    return {"allreduce": port_allreduce(mesh), "qr": port_qr(mesh)}


PARTS = ("allreduce", "qr")


def _both_sides(tmp: Path) -> tuple[list, dict]:
    """The port's per-rank outputs of :func:`port_cases` from a world of
    :data:`P` CPU ranks (rendezvous under ``tmp``), and the reference's
    outputs of the same cases from this module run as a script with
    ``XLA_FLAGS`` forcing :data:`P` host devices, once for each part.  The
    world and the two scripts run at the same time."""
    from repro_torch.collective.dist import run_ranks

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root / "src"), str(root / "tests")]),
               JAX_PLATFORMS="cpu", XLA_FLAGS=f"--xla_force_host_platform_device_count={P}",
               TMPDIR=str(tmp))
    procs = {part: subprocess.Popen([sys.executable, __file__, str(tmp / f"{part}.pkl"), part],
                                    env=env, cwd=root, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for part in PARTS}
    ref = {}
    try:
        port = run_ranks(port_cases, P, device="cpu", rendezvous_dir=tmp)
        for part, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
            with open(tmp / f"{part}.pkl", "rb") as f:
                ref[part] = pickle.load(f)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert all(out["devices"] == P for out in ref.values())
    return port, ref


def both_sides(tmp_path_factory, part: str) -> tuple[list, dict]:
    """``(port, reference)`` for ``part`` (``"allreduce"`` or ``"qr"``): the
    port's per-rank outputs and the reference's outputs.

    Both parts are computed once per test session, in one world and one
    reference subprocess a part: the first module to ask computes them under a
    file lock in the session's temporary directory (shared by the xdist
    workers of one run) and pickles them there; every later ask reads that
    file."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    done = base / "dist_parity_sides.pkl"
    with open(base / "dist_parity_sides.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            work = base / "dist_parity"
            work.mkdir(exist_ok=True)
            sides = _both_sides(work)
            with open(work / "sides.pkl", "wb") as f:
                pickle.dump(sides, f)
            os.replace(work / "sides.pkl", done)
        with open(done, "rb") as f:
            port, ref = pickle.load(f)
    return [out[part] for out in port], ref[part]


def fail_on_rank(mesh, bad: int) -> int:
    """A rank function that raises on rank ``bad``."""
    if mesh.rank == bad:
        raise ValueError(f"boom on rank {bad}")
    return mesh.rank


def guard_in_world(mesh) -> tuple[int, str]:
    """The retrace guard run on this rank: (failures, what it printed)."""
    import contextlib
    import io
    import warnings

    from repro_torch.bench.cases import dispatch

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        failures = dispatch.guard()
    return failures, buf.getvalue()


def _jtracked(fn):
    from repro.kernels import dispatch as disp
    from repro.kernels import traffic

    with disp.track_dispatch() as d, traffic.track_traffic() as t:
        out = fn()
    return out, d.as_dict(), t.as_dict()


def _reference_allreduce() -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Spec
    from repro.collective import (
        FaultSpec,
        InstrumentedComm,
        ShardMapComm,
        SimComm,
        execute_plan,
        ft_allreduce,
        ft_allreduce_jit,
        make_plan,
    )
    from repro.compat import make_mesh, shard_map
    from repro.kernels import dispatch as disp

    mesh = make_mesh((P,), ("rows",))
    comm = ShardMapComm(P, "rows")
    ins = {k: jnp.asarray(v) for k, v in allreduce_inputs().items()}

    def spmd(body, n_out):
        return jax.jit(shard_map(body, mesh=mesh, in_specs=Spec("rows"),
                                 out_specs=(Spec("rows"),) * n_out))

    out: dict = {}
    for deaths in (None, DEATHS):
        for op in OPS:
            for variant in (VARIANTS if deaths is None else FAULTED):
                fs = FaultSpec.of(deaths) if deaths else None

                def body(blk, op=op, variant=variant, fs=fs):
                    v, ok = ft_allreduce(blk[0], comm, op=op, variant=variant, fault_spec=fs)
                    return v[None], ok[None]

                v, ok = spmd(body, 2)(ins["x"])
                out[("ar", op, variant, _key(deaths))] = (np.asarray(v), np.asarray(ok))
    for op in FAST_OPS:
        payload = ins["tall" if op == "qr" else "sym"]
        for variant in VARIANTS:
            plan = make_plan(variant, P)

            def body(blk, op=op, plan=plan):
                va, oa = execute_plan(blk[0], comm, plan, op)
                return va[None], oa[None]

            va, oa = spmd(body, 2)(payload)
            out[("fast", op, variant)] = (np.asarray(va), np.asarray(oa))
    for op, variant, deaths in COUNTED:
        ic = InstrumentedComm(comm)

        def body(blk, op=op, variant=variant, deaths=deaths, ic=ic):
            v, ok = ft_allreduce(blk[0], ic, op=op, variant=variant,
                                 fault_spec=FaultSpec.of(deaths) if deaths else None)
            return v[None], ok[None]

        spmd(body, 2)(ins["sym" if op == "gram_sum" else "x"])
        out[("count", op, variant, _key(deaths))] = ic.stats.as_dict()
    sim = SimComm(P)
    for op, name in (("sum", "xj"), ("gram_sum", "symj")):
        (vm, okm), d, _ = _jtracked(lambda: ft_allreduce_jit(ins[name], comm, op=op, mesh=mesh))
        vs, oks = ft_allreduce_jit(ins[name], sim, op=op)
        out[("jit", op)] = (np.asarray(vm), np.asarray(okm), np.asarray(vs), np.asarray(oks), d)
    plan = make_plan("redundant", P, FaultSpec.of(DEATHS))
    vm, okm = ft_allreduce_jit(ins["xj"], comm, op="sum", plan=plan, mesh=mesh)
    out["jit_faulted"] = (np.asarray(vm), np.asarray(okm))
    before = disp.trace_count("ft_allreduce")
    _, d, _ = _jtracked(lambda: ft_allreduce_jit(ins["xj"], comm, op="sum", plan=plan, mesh=mesh))
    out["jit_warm"] = (disp.trace_count("ft_allreduce") - before, d)
    errors = {}
    for name, bad in (("no_mesh", None), ("size", make_mesh((4,), ("rows",))),
                      ("axis", make_mesh((P,), ("x",)))):
        try:
            ft_allreduce_jit(ins["xj"], comm, op="sum", mesh=bad)
        except ValueError as e:
            errors[name] = str(e)
    out["jit_errors"] = errors
    return out


def _reference_qr() -> dict:
    import jax.numpy as jnp
    from repro.collective import FaultSpec
    from repro.compat import make_mesh
    from repro.core import ref
    from repro.qr import (
        PanelFaultSchedule,
        QRConfig,
        blocked_qr_shard_map,
        factorize,
        tsqr_gram_shard_map,
        tsqr_shard_map,
    )

    mesh = make_mesh((P,), ("rows",))
    ins = {k: jnp.asarray(v.reshape(-1, v.shape[-1])) for k, v in qr_inputs(ref).items()}
    a, b, w = ins["tsqr"], ins["blocked"], ins["wide"]
    out: dict = {}

    def tsqr_row(res):
        return (np.asarray(res.r), np.asarray(res.valid), res.plan.final_valid,
                res.plan.message_count())

    _, d, t = _jtracked(lambda: tsqr_shard_map(a, mesh=mesh, axis="rows", variant="tree"))
    out["tsqr_first"] = (d, t)
    _, d, t = _jtracked(lambda: tsqr_shard_map(a, mesh=mesh, axis="rows", variant="tree"))
    out["tsqr_warm"] = (d, t)
    for v in VARIANTS:
        out[("tsqr", v, "none")] = tsqr_row(tsqr_shard_map(a, mesh=mesh, axis="rows", variant=v))
    for deaths in QR_SPECS:
        for v in FAULTED:
            res = factorize(a, QRConfig(variant=v), faults=FaultSpec.of(deaths), mesh=mesh)
            out[("tsqr", v, _key(deaths))] = tsqr_row(res)
    res = tsqr_shard_map(a, mesh=mesh, axis="rows", variant="redundant", compute_q=True)
    out["tsqr_q"] = (np.asarray(res.r), np.asarray(res.q))
    res, d, t = _jtracked(lambda: factorize(w, QRConfig(local_r="cqr2_pallas", compute_q=True),
                                            mesh=mesh))
    out["tsqr_kernels"] = (np.asarray(res.r), np.asarray(res.q), d, t)
    res, d, t = _jtracked(lambda: factorize(w, QRConfig(gram=True), mesh=mesh))
    shim = tsqr_gram_shard_map(w, mesh=mesh, axis="rows")
    out["gram"] = (np.asarray(res.r), np.asarray(res.valid), np.asarray(res.q), d, t,
                   np.asarray(shim.r), np.asarray(shim.q), res.plan.final_valid)
    first = _jtracked(lambda: blocked_qr_shard_map(b, mesh=mesh, axis="rows", panel_width=4,
                                                   compute_q=True))
    warm = _jtracked(lambda: blocked_qr_shard_map(b, mesh=mesh, axis="rows", panel_width=4,
                                                  compute_q=True))
    res = first[0]
    out["blocked"] = (np.asarray(res.r), np.asarray(res.valid), np.asarray(res.q), first[1:],
                      warm[1:])
    sched = PanelFaultSchedule.of(**SCHEDULE)
    first = _jtracked(lambda: blocked_qr_shard_map(b, mesh=mesh, axis="rows", panel_width=4,
                                                   variant="replace", faults=sched))
    warm = _jtracked(lambda: factorize(b, QRConfig(panel_width=4, variant="replace"),
                                       faults=sched, mesh=mesh))
    res = first[0]
    out["blocked_faulted"] = (np.asarray(res.r), np.asarray(res.valid), first[1:], warm[1:],
                              _reports(res.reports))
    off = factorize(b, QRConfig(panel_width=4, variant="replace", recover="off"),
                    faults=sched, mesh=mesh)
    out["blocked_no_recovery"] = (np.asarray(off.r), np.asarray(off.valid), _reports(off.reports))
    return out


if __name__ == "__main__":
    import warnings

    import jax_reference  # noqa: F401  (before any repro import)
    import jax

    warnings.simplefilter("ignore", DeprecationWarning)
    result = {"devices": jax.device_count()}
    result.update(_reference_allreduce() if sys.argv[2] == "allreduce" else _reference_qr())
    with open(sys.argv[1], "wb") as f:
        pickle.dump(result, f)
