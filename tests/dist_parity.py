"""Shared cases of the mesh-route parity tests (``test_torch_dist.py``,
``test_torch_dist_qr.py`` and ``test_torch_dist_powersgd.py``): the cases
of the reference's own SPMD tests (``tests/test_spmd.py``) and of
``examples/powersgd_dp.py``, computed once per test session on each side
(:func:`both_sides`), in three parts: ``"allreduce"``, ``"qr"`` and
``"powersgd"`` (the last on a 2 × 4 data × model view of the same world).

* The port runs them in one world of :data:`P` CPU ranks
  (:func:`repro_torch.collective.dist.run_ranks`): :func:`port_cases` is
  the rank function, returning this rank's outputs as numpy arrays, bools,
  strings and dicts.  This module imports neither JAX nor the port at
  import time, so the spawned ranks load only torch.
* The reference runs them under ``shard_map`` over :data:`P` forced host
  devices in three subprocesses, one a part (this module run as a script
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


# The PowerSGD part: a (D, M) data x model view of the same world
PSGD = dict(D=2, M=4, m_loc=8, n=12, r=3)           # tests/test_spmd.py:121
# (label, error feedback, deaths, variant)
PSGD_RUNS = (("plain", False, None, "redundant"), ("ef", True, None, "redundant"),
             ("selfhealing", False, {1: 1}, "selfhealing"),
             ("redundant", False, {1: 1}, "redundant"))
AXES = ("data", "model")
MESH_CALLS = (("production", "make_production_mesh", {}),
              ("production_multi_pod", "make_production_mesh", {"multi_pod": True}),
              ("tsqr", "make_tsqr_mesh", {}),
              ("tsqr_multi_pod", "make_tsqr_mesh", {"multi_pod": True}),
              ("smoke_4x4", "make_smoke_mesh", {"data": 4, "model": 4}))
SMOKE_MESHES = ((1, 1), (2, 2))
# examples/powersgd_dp.py's widths and settings
EXAMPLE = dict(D=2, M=4, DIN=64, DH=128, DOUT=32, BATCH=256, RANK=8, STEPS=80, LR=0.3)
EXAMPLE_STEPS, EXAMPLE_FAULT = 6, 3


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


def powersgd_inputs() -> dict[str, np.ndarray]:
    """The PowerSGD part's payloads: a distinct rank-r gradient per data
    replica (D, M·m_loc, n) as in ``tests/test_spmd.py:121``, the start
    basis, an error buffer, one (3, 5) block a rank for the axis
    collectives (rank 6's holds a NaN) and a cotangent a rank for each
    axis' gathered block."""
    D, M, m_loc, n, r = (PSGD[k] for k in ("D", "M", "m_loc", "n", "r"))
    rng = np.random.default_rng(17)
    u = rng.standard_normal((D, M * m_loc, r), dtype=np.float32)
    v = rng.standard_normal((n, r), dtype=np.float32)
    coll = rng.standard_normal((P, 3, 5), dtype=np.float32)
    coll[6, 0, 1] = np.nan
    return {"g": np.einsum("dmr,nr->dmn", u, v), "q0": rng.standard_normal((n, r), dtype=np.float32),
            "e0": 0.1 * rng.standard_normal((D, M * m_loc, n), dtype=np.float32),
            "coll": coll,
            "cot_data": rng.standard_normal((P, D * 3, 5), dtype=np.float32),
            "cot_model": rng.standard_normal((P, M * 3, 5), dtype=np.float32)}


def example_inputs() -> dict[str, np.ndarray]:
    """The example's data and initial state at its widths, from a numpy
    seed (both sides get these arrays)."""
    ex = EXAMPLE
    rng = np.random.default_rng(23)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    w_true1, w_true2 = normal(ex["DIN"], ex["DH"]) / 8, normal(ex["DH"], ex["DOUT"]) / 8
    x = normal(ex["D"], ex["BATCH"], ex["DIN"])
    return {"x": x, "y": np.maximum(x @ w_true1, 0) @ w_true2,
            "w1": normal(ex["DIN"], ex["DH"]) * 0.05, "w2": normal(ex["DH"], ex["DOUT"]) * 0.05,
            "q1": normal(ex["DH"], ex["RANK"])}


def _error(fn) -> str | None:
    """``fn()``'s error as "Type: message", or None when it returns."""
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


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


def port_powersgd(mesh) -> dict:
    """This rank's outputs of the PowerSGD part, on a (D, M) data x model
    mesh laid over the world."""
    import torch

    from repro_torch.collective import FaultSpec, ShardMapComm
    from repro_torch.collective.dist import all_gather, pmean, psum
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import powersgd_dp
    from repro_torch.optim import powersgd

    out: dict = {"rank": mesh.rank}
    # no data x model mesh yet: the world's 1-D "rows" mesh has no model line
    out["refused"] = {(n, axis): _error(lambda n=n, axis=axis: ShardMapComm(n, axis))
                      for n, axis in ((4, "model"), (8, "model"))}
    out["mesh_errors"] = {name: _error(lambda fn=fn, kw=kw: getattr(launch_mesh, fn)(**kw))
                          for name, fn, kw in MESH_CALLS}
    smoke = {}
    for dims in SMOKE_MESHES:
        small = launch_mesh.make_smoke_mesh(*dims)
        smoke[dims] = None if small is None else (small.shape, small.members)
    out["smoke"] = smoke
    D, M, m_loc, n, r = (PSGD[k] for k in ("D", "M", "m_loc", "n", "r"))
    grid = launch_mesh.make_smoke_mesh(D, M)
    d, m = grid.index("data"), grid.index("model")
    out["grid"] = (grid.shape, grid.members, grid.rank, d, m,
                   grid.line("data").members, grid.line("model").members)
    comms = {}
    for size, axis in ((4, "model"), (2, "data"), (8, "rows"), (8, "model"), (4, "data"),
                       (4, "rows"), (2, "pod")):
        try:
            c = ShardMapComm(size, axis)
            comms[(size, axis)] = (c.members, c.rank, c.n_ranks)
        except ValueError as e:
            comms[(size, axis)] = f"ValueError: {e}"
    out["comms"] = comms

    ins = powersgd_inputs()
    me = grid.rank
    x = torch.from_numpy(ins["coll"][me])
    coll = {}
    for axis in AXES:
        coll[("psum", axis)] = _np(psum(x, axis, grid))
        coll[("pmean", axis)] = _np(pmean(x, axis, grid))
        coll[("all_gather", axis)] = _np(all_gather(x, axis, grid))
        var = x.clone().requires_grad_()
        cot = torch.from_numpy(ins[f"cot_{axis}"][me])
        coll[("grad", axis)] = _np(torch.autograd.grad((all_gather(var, axis, grid) * cot).sum(),
                                                       var)[0])
    out["coll"] = coll

    rows = slice(m * m_loc, (m + 1) * m_loc)
    g, e0 = torch.from_numpy(ins["g"][d, rows]), torch.from_numpy(ins["e0"][d, rows])
    comm = ShardMapComm(M, "model")
    runs = {}
    for label, ef, deaths, variant in PSGD_RUNS:
        cfg = powersgd.PowerSGDConfig(rank=r, error_feedback=ef, variant=variant)
        state = {"q": torch.from_numpy(ins["q0"]), "e": e0 if ef else None}
        ghat, new, stats = powersgd.compress_grad(
            g, state, comm, cfg=cfg, psum_data=lambda v: psum(v, "data", grid),
            psum_model=lambda v: psum(v, "model", grid), n_data=D,
            fault_spec=FaultSpec.of(deaths) if deaths else None)
        runs[label] = (_np(ghat), _np(new["q"]), _np(new["e"]), bool(stats["valid"]),
                       stats["data_bytes_compressed"], stats["data_bytes_dense"])
    out["psgd"] = runs
    out["example"] = powersgd_dp.train(grid, example_inputs(), EXAMPLE_STEPS, EXAMPLE_FAULT)
    full = powersgd_dp.rank_main(mesh)     # the entry point's own rank body
    out["example_full"] = {k: full[k] for k in ("losses", "valid_at_fault", "bytes")}
    # a smaller data x model mesh built after the 2 x 4 ones: every rank,
    # inside it or not, resolves the model axis on it
    launch_mesh.make_smoke_mesh(2, 2)
    out["after_smaller"] = {(size, axis): _error(lambda size=size, axis=axis: ShardMapComm(
        size, axis).members) for size, axis in ((4, "model"), (2, "model"))}
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
    """This rank's outputs of every case: the all-reduce's, the QR's, then
    PowerSGD's."""
    return {"allreduce": port_allreduce(mesh), "qr": port_qr(mesh),
            "powersgd": port_powersgd(mesh)}


PARTS = ("allreduce", "qr", "powersgd")


def _both_sides(tmp: Path) -> tuple[list, dict]:
    """The port's per-rank outputs of :func:`port_cases` from a world of
    :data:`P` CPU ranks (rendezvous under ``tmp``), and the reference's
    outputs of the same cases from this module run as a script with
    ``XLA_FLAGS`` forcing :data:`P` host devices, once for each part.  The
    world and the three scripts run at the same time."""
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
    """``(port, reference)`` for ``part`` (one of :data:`PARTS`): the
    port's per-rank outputs and the reference's outputs.

    Every part is computed once per test session, in one world and one
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


def _reference_powersgd() -> dict:
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as Spec
    from repro.collective import FaultSpec, ShardMapComm
    from repro.compat import make_mesh, shard_map
    from repro.launch import mesh as launch_mesh
    from repro.optim import powersgd

    out: dict = {}
    out["mesh_errors"] = {name: _error(lambda fn=fn, kw=kw: getattr(launch_mesh, fn)(**kw))
                          for name, fn, kw in MESH_CALLS}
    smoke = {}
    for dims in SMOKE_MESHES:
        small = launch_mesh.make_smoke_mesh(*dims)
        smoke[dims] = (dict(small.shape), tuple(dev.id for dev in small.devices.flat))
    out["smoke"] = smoke
    D, M, m_loc, n, r = (PSGD[k] for k in ("D", "M", "m_loc", "n", "r"))
    grid = make_mesh((D, M), ("data", "model"))
    out["grid"] = (dict(grid.shape), tuple(dev.id for dev in grid.devices.flat))
    ins = {k: jnp.asarray(v) for k, v in powersgd_inputs().items()}
    flat = Spec(("data", "model"))

    def per_rank(body, *args):
        return np.asarray(jax.jit(shard_map(body, mesh=grid, in_specs=(flat,) * len(args),
                                            out_specs=flat))(*args))

    coll = {}
    for axis in AXES:
        coll[("psum", axis)] = per_rank(lambda b, axis=axis: lax.psum(b[0], axis)[None],
                                        ins["coll"])
        coll[("pmean", axis)] = per_rank(lambda b, axis=axis: lax.pmean(b[0], axis)[None],
                                         ins["coll"])
        coll[("all_gather", axis)] = per_rank(
            lambda b, axis=axis: lax.all_gather(b[0], axis, axis=0, tiled=True)[None],
            ins["coll"])

        def grad(b, c, axis=axis):
            def loss(v):
                return jnp.sum(lax.all_gather(v, axis, axis=0, tiled=True) * c[0])

            return jax.grad(loss)(b[0])[None]

        coll[("grad", axis)] = per_rank(grad, ins["coll"], ins[f"cot_{axis}"])
    out["coll"] = coll

    comm = ShardMapComm(M, "model")
    blocks = Spec("data", "model", None)
    runs = {}
    for label, ef, deaths, variant in PSGD_RUNS:
        cfg = powersgd.PowerSGDConfig(rank=r, error_feedback=ef, variant=variant)
        fs = FaultSpec.of(deaths) if deaths else None
        counts = {}

        def body(g_blk, e_blk, q, cfg=cfg, fs=fs, ef=ef, counts=counts):
            state = {"q": q, "e": e_blk[0] if ef else None}
            ghat, new, stats = powersgd.compress_grad(
                g_blk[0], state, comm, cfg=cfg, psum_data=lambda v: lax.psum(v, "data"),
                psum_model=lambda v: lax.psum(v, "model"), n_data=D, fault_spec=fs)
            counts["bytes"] = (stats["data_bytes_compressed"], stats["data_bytes_dense"])
            e_new = new["e"] if ef else jnp.zeros_like(ghat)
            return ghat[None], new["q"][None], e_new[None], stats["valid"][None]

        f = jax.jit(shard_map(body, mesh=grid, in_specs=(blocks, blocks, Spec()),
                              out_specs=(blocks, flat, blocks, flat)))
        ghat, q, e, valid = f(ins["g"], ins["e0"], ins["q0"])
        runs[label] = (np.asarray(ghat), np.asarray(q), np.asarray(e) if ef else None,
                       np.asarray(valid), *counts["bytes"])
    out["psgd"] = runs
    out["example"] = _reference_example(grid)
    return out


def _reference_example(mesh) -> dict:
    """``examples/powersgd_dp.py``'s training loop on :func:`example_inputs`
    for :data:`EXAMPLE_STEPS` steps with the fault on step
    :data:`EXAMPLE_FAULT`: its step function, specs and loss line as the
    example writes them."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as Spec
    from repro.collective import FaultSpec, ShardMapComm
    from repro.compat import shard_map
    from repro.optim import powersgd

    ex = EXAMPLE
    D, M, LR = ex["D"], ex["M"], ex["LR"]
    ins = {k: jnp.asarray(v) for k, v in example_inputs().items()}
    x, y, w1, w2, q1 = (ins[k] for k in ("x", "y", "w1", "w2", "q1"))
    e1 = jnp.zeros((ex["DIN"], ex["DH"]), jnp.float32)
    psgd_cfg = powersgd.PowerSGDConfig(rank=ex["RANK"], error_feedback=True,
                                       variant="selfhealing")
    comm = ShardMapComm(M, "model")

    def loss_fn(w1_blk, w2_full, xb, yb):
        w1_full = lax.all_gather(w1_blk, "model", axis=0, tiled=True)
        pred = jnp.maximum(xb @ w1_full, 0) @ w2_full
        return jnp.mean((pred - yb) ** 2)

    def make_step(fault_spec):
        def step(w1_blk, w2_full, q, e, xb, yb):
            g1_blk, g2 = jax.grad(loss_fn, argnums=(0, 1))(w1_blk, w2_full, xb[0], yb[0])
            g2_mean = lax.pmean(g2, "data")
            state = {"q": q, "e": e}
            g1_hat, new_state, stats = powersgd.compress_grad(
                g1_blk, state, comm, cfg=psgd_cfg,
                psum_data=lambda v: lax.psum(v, "data"),
                psum_model=lambda v: lax.psum(v, "model"),
                n_data=D, fault_spec=fault_spec)
            return (w1_blk - LR * g1_hat, w2_full - LR * g2_mean,
                    new_state["q"], new_state["e"],
                    jnp.asarray(stats["data_bytes_compressed"]),
                    jnp.asarray(stats["data_bytes_dense"]))

        return jax.jit(shard_map(
            step, mesh=mesh,
            in_specs=(Spec("model", None), Spec(), Spec(), Spec("model", None),
                      Spec("data", None, None), Spec("data", None, None)),
            out_specs=(Spec("model", None), Spec(), Spec(), Spec("model", None), Spec(), Spec()),
        ))

    step_ok, step_fault = make_step(None), make_step(FaultSpec.of({1: 1}))
    losses = []
    for i in range(EXAMPLE_STEPS):
        fn = step_fault if i == EXAMPLE_FAULT else step_ok
        w1, w2, q1, e1, b_comp, b_dense = fn(w1, w2, q1, e1, x, y)
        losses.append(float(jnp.mean((jnp.maximum(x[0] @ w1, 0) @ w2 - y[0]) ** 2)))
    shards = {s.device.id: np.asarray(s.data) for s in e1.addressable_shards}
    return {"losses": losses, "w1": np.asarray(w1), "w2": np.asarray(w2), "q": np.asarray(q1),
            "e": [shards[i] for i in range(P)], "bytes": (int(b_comp), int(b_dense))}


if __name__ == "__main__":
    import warnings

    import jax_reference  # noqa: F401  (before any repro import)
    import jax

    warnings.simplefilter("ignore", DeprecationWarning)
    result = {"devices": jax.device_count()}
    result.update({"allreduce": _reference_allreduce, "qr": _reference_qr,
                   "powersgd": _reference_powersgd}[sys.argv[2]]())
    with open(sys.argv[1], "wb") as f:
        pickle.dump(result, f)
