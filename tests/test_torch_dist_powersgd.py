"""PowerSGD across processes on a data × model rank mesh against the
reference's PowerSGD under ``shard_map`` on a (data=2, model=4) device mesh
(``tests/test_spmd.py:121``, ``examples/powersgd_dp.py``).

The port's side runs in the session's one world of 8 CPU ranks, viewed as
a 2 × 4 data × model mesh (``launch/mesh.py::make_smoke_mesh``); the
reference's in a subprocess with 8 forced host devices; both once per test
session, shared with ``test_torch_dist.py`` and ``test_torch_dist_qr.py``
(``dist_parity.both_sides``, part ``"powersgd"``).  Held exactly: validity
bits, NaN placement, byte counts, mesh layouts, error messages.  Held
within ``TOL`` (``test_torch_dist.py``'s): values.  Held within the port:
every sum is bit-identical on the ranks of its line, so ĝ is the same bits
on the two ranks of each data line and the new basis on all eight.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)

import dist_parity as dp  # noqa: E402
from repro_torch.collective import FaultSpec, make_plan  # noqa: E402
from repro_torch.collective import dist  # noqa: E402
from repro_torch.collective.dist import RankMesh  # noqa: E402
from repro_torch.launch import powersgd_dp  # noqa: E402

TOL = dict(rtol=5e-4, atol=5e-4)
D, M, M_LOC = dp.PSGD["D"], dp.PSGD["M"], dp.PSGD["m_loc"]
COLL = [(op, axis) for op in ("psum", "pmean", "all_gather", "grad") for axis in dp.AXES]
LABELS = [run[0] for run in dp.PSGD_RUNS]
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return dp.both_sides(tmp_path_factory, "powersgd")


def _bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                                        b.view(np.int32))


def _rows(m):
    return slice(m * M_LOC, (m + 1) * M_LOC)


def _close(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("label", LABELS)
def test_compress_grad_matches_reference(sides, label):
    """ĝ, the new state (q is S̄, e), the validity bit and both byte counts
    of every rank against the reference's device of the same coordinates."""
    port, ref = sides
    _, ef, deaths, variant = next(run for run in dp.PSGD_RUNS if run[0] == label)
    wg, wq, we, wvalid, wcomp, wdense = ref["psgd"][label]
    plan = make_plan(variant, M, FaultSpec.of(deaths) if deaths else None)
    for rank, out in enumerate(port):
        d, m = divmod(rank, M)
        ghat, q, e, valid, comp, dense = out["psgd"][label]
        _close(ghat, wg[d, _rows(m)])
        _close(q, wq[rank])
        assert (e is None) == (not ef)
        if ef:
            _close(e, we[d, _rows(m)])
        assert valid == bool(wvalid[rank]) == bool(plan.final_valid[m])
        assert (comp, dense) == (wcomp, wdense)
        assert comp == 4 * dp.PSGD["r"] * (M_LOC * M + dp.PSGD["n"])
    if label == "plain":   # tests/test_spmd.py:121: a rank-r gradient comes back exactly
        mean = dp.powersgd_inputs()["g"].mean(0)
        for rank, out in enumerate(port):
            np.testing.assert_allclose(out["psgd"][label][0], mean[_rows(rank % M)],
                                       rtol=2e-3, atol=2e-3)
    if deaths is not None and variant == "redundant":
        assert not all(out["psgd"][label][3] for out in port)   # a NaN-poisoned line


@pytest.mark.parametrize("label", LABELS)
def test_ghat_is_the_same_bits_on_each_data_line(sides, label):
    """The reference's "ĝ now bit-identical on every replica": the two
    ranks of each data line hold the same ĝ bits, and all eight the same
    new basis S̄."""
    port, _ = sides
    for m in range(M):
        assert _bits(port[m]["psgd"][label][0], port[M + m]["psgd"][label][0])
    for out in port[1:]:
        assert _bits(out["psgd"][label][1], port[0]["psgd"][label][1])


@pytest.mark.parametrize("op,axis", COLL, ids=[f"{op}-{axis}" for op, axis in COLL])
def test_axis_collective_matches_reference(sides, op, axis):
    """``psum``, ``pmean``, the tiled ``all_gather`` and ``all_gather``'s
    gradient over each axis, NaN placement included (rank 6's block holds a
    NaN).  The gradient is the reference's transpose, a ``psum_scatter``:
    the line's cotangents summed, this rank's slice."""
    port, ref = sides
    want = ref["coll"][(op, axis)]
    for rank, out in enumerate(port):
        _close(out["coll"][(op, axis)], want[rank])
    if op in ("psum", "pmean"):   # the same bits on every rank of the line
        grid = port[0]["grid"]
        line_of = {"data": 5, "model": 6}[axis]
        for rank, out in enumerate(port):
            line = out["grid"][line_of]
            assert _bits(out["coll"][(op, axis)], port[line[0]]["coll"][(op, axis)]), (rank, line)
        assert grid[0] == {"data": D, "model": M}


def test_example_six_steps_match_reference(sides):
    """``examples/powersgd_dp.py``'s step for 6 steps, the fault on step 3,
    on the same arrays: each step's loss, the final w1 (data replica 0's
    rows), w2, S̄, every rank's error buffer, the byte counts; every rank
    valid on the fault step."""
    port, ref = sides
    want = ref["example"]
    assert len(want["losses"]) == dp.EXAMPLE_STEPS
    for out in port:
        np.testing.assert_allclose(out["example"]["losses"], want["losses"], **TOL)
        _close(out["example"]["w2"], want["w2"])
        _close(out["example"]["q"], want["q"])
        assert out["example"]["bytes"] == want["bytes"]
        assert out["example"]["valid_at_fault"] is True
    _close(np.concatenate([out["example"]["w1"] for out in port[:M]]), want["w1"])
    for rank, out in enumerate(port):
        _close(out["example"]["e"], want["e"][rank])


def test_example_state_is_the_same_bits_on_its_lines(sides):
    """After the 6 steps, w1 and the last ĝ are the same bits on the two
    ranks of each data line, w2 and S̄ on all eight, and the losses too."""
    port, _ = sides
    for m in range(M):
        for key in ("w1", "g1_hat"):
            assert _bits(port[m]["example"][key], port[M + m]["example"][key])
    for out in port[1:]:
        for key in ("w2", "q"):
            assert _bits(out["example"][key], port[0]["example"][key])
        assert out["example"]["losses"] == port[0]["example"]["losses"]


def test_example_at_full_length_meets_its_own_check(sides):
    """The entry point's rank body (80 steps, its own seed): final loss under a
    quarter of the first (the example's assert), every rank valid on the
    fault step, and the example's byte line (6144 compressed, 32768 dense)."""
    port, _ = sides
    losses = port[0]["example_full"]["losses"]
    assert len(losses) == powersgd_dp.STEPS and losses[-1] < 0.25 * losses[0]
    for out in port:
        assert out["example_full"]["valid_at_fault"] is True
        assert out["example_full"]["bytes"] == (6144, 32768)


def test_example_constants_are_the_reference_example_s():
    """The entry point's widths and settings, read from the reference's
    example without importing it (it sets ``XLA_FLAGS`` on import)."""
    consts = {}
    for node in ast.parse((ROOT / "examples" / "powersgd_dp.py").read_text()).body:
        if isinstance(node, ast.Assign) and isinstance(node.value, (ast.Constant, ast.Tuple)):
            target = node.targets[0]
            names = target.elts if isinstance(target, ast.Tuple) else [target]
            values = ast.literal_eval(node.value)
            consts.update(zip([n.id for n in names],
                              values if isinstance(target, ast.Tuple) else [values]))
    for name in ("D", "M", "DIN", "DH", "DOUT", "RANK", "STEPS", "LR"):
        assert getattr(powersgd_dp, name) == consts[name] == dp.EXAMPLE[name], name
    assert powersgd_dp.BATCH == dp.EXAMPLE["BATCH"] == 256   # (D, 256, DIN) in the example
    assert powersgd_dp.FAULT == {1: 1}


def test_launch_meshes_match_reference(sides):
    """``launch/mesh.py`` over the world of 8: the reference's errors on 8
    devices word for word; the smoke meshes' shapes and members (a rank
    outside one gets None); the 2 × 4 mesh row-major, each rank's indices
    and the members of its two lines."""
    port, ref = sides
    assert set(ref["mesh_errors"]) == {name for name, _, _ in dp.MESH_CALLS}
    assert all(msg.startswith("ValueError: Number of devices 8") for msg in
               ref["mesh_errors"].values())
    wshape, wids = ref["grid"]
    grid_ids = np.array(wids).reshape(D, M)
    for rank, out in enumerate(port):
        assert out["mesh_errors"] == ref["mesh_errors"]
        for dims, (shape, ids) in ref["smoke"].items():
            got = out["smoke"][dims]
            assert got == (None if rank >= len(ids) else (shape, ids)), (rank, dims)
        shape, members, me, d, m, data_line, model_line = out["grid"]
        assert shape == wshape and members == wids and me == rank
        assert (d, m) == divmod(rank, M)
        assert data_line == tuple(grid_ids[:, m]) and model_line == tuple(grid_ids[d, :])


def test_shard_map_comm_resolves_to_the_rank_line(sides):
    """On the 2 × 4 mesh ``ShardMapComm(4, "model")`` is this rank's model
    line (its group, members and rank), ``ShardMapComm(2, "data")`` its
    data line, ``(8, "rows")`` the world as before; a size or an axis that
    no line has raises."""
    port, _ = sides
    for rank, out in enumerate(port):
        _, _, _, d, m, data_line, model_line = out["grid"]
        comms = out["comms"]
        assert comms[(4, "model")] == (model_line, m, 4)
        assert comms[(2, "data")] == (data_line, d, 2)
        assert comms[(8, "rows")] == (tuple(range(8)), rank, 8)
        assert comms[(8, "model")] == "ValueError: mesh axis 'model' has 4 ranks but n_ranks=8"
        assert comms[(4, "data")] == "ValueError: mesh axis 'data' has 2 ranks but n_ranks=4"
        assert comms[(4, "rows")] == "ValueError: mesh axis 'rows' has 8 ranks but n_ranks=4"
        assert comms[(2, "pod")].startswith("ValueError: no mesh of this rank has an axis 'pod'")


def test_shard_map_comm_refuses_outside_a_2d_mesh(sides):
    """Before any data × model mesh exists, a model-axis comm raises in the
    world of 8 "rows" ranks, whatever its size: no fallback to the world's
    group."""
    port, _ = sides
    for out in port:
        for size in (4, 8):
            assert out["refused"][(size, "model")].startswith(
                "ValueError: no mesh of this rank has an axis 'model'")


def test_shard_map_comm_resolves_on_the_newest_mesh_on_every_rank(sides):
    """After a 2 × 2 mesh built past the 2 × 4 ones, every rank resolves the
    model axis on the 2 × 2 mesh: a comm of 4 raises on all eight ranks
    (the model line has 2 ranks on ranks 0–3, and ranks 4–7 are outside the
    mesh), and a comm of 2 is the line of ranks 0–3 alone."""
    port, _ = sides
    outside = ("ValueError: this rank is outside the newest mesh with an axis 'model' "
               "(axes ('data', 'model'))")
    for rank, out in enumerate(port):
        got = out["after_smaller"]
        if rank < 4:
            assert got[(4, "model")] == "ValueError: mesh axis 'model' has 2 ranks but n_ranks=4"
            assert got[(2, "model")] is None
        else:
            assert got == {(4, "model"): outside, (2, "model"): outside}


# ---------------------------------------------------------------------------
# Units in this process
# ---------------------------------------------------------------------------

def test_rank_mesh_layout_units():
    """A mesh's ``dims`` lay out its members; a 1-D mesh compares and hashes
    as it did before meshes had more axes."""
    cpu = torch.device("cpu")
    grid = RankMesh(("data", "model"), tuple(range(8)), cpu, dims=(2, 4))
    assert grid.shape == {"data": 2, "model": 4} and grid.size == 8
    assert grid != RankMesh(("data", "model"), tuple(range(8)), cpu, dims=(4, 2))
    flat = RankMesh(("rows",), (0, 1, 2, 3), cpu)
    assert flat.dims == (4,) and flat.shape == {"rows": 4}
    assert flat == RankMesh(("rows",), (0, 1, 2, 3), cpu, dims=(4,), group=object())
    assert hash(flat) == hash(RankMesh(("rows",), (0, 1, 2, 3), cpu))
    assert flat.line("rows") is flat
    with pytest.raises(ValueError, match="do not lay out 8 members"):
        RankMesh(("data", "model"), tuple(range(8)), cpu, dims=(2, 3))
    with pytest.raises(ValueError, match="do not include 'model'"):
        flat.line("model")
    with pytest.raises(ValueError, match="no line groups"):
        grid.line("model")
    with pytest.raises(RuntimeError, match="rank world"):
        dist.make_rank_mesh((2, 4), ("data", "model"))


def test_axis_collectives_on_a_world_of_one():
    """On a line of one rank the sums are the value, the gather the block,
    and the gather's gradient the cotangent; ``psum`` refuses a tensor that
    needs a gradient rather than drop it."""
    with dist.local_mesh("rows", "cpu") as mesh:
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(dist.psum(x, "rows", mesh), x)
        assert torch.equal(dist.pmean(x, "rows", mesh), x)
        var = x.clone().requires_grad_()
        out = dist.all_gather(var, "rows", mesh)
        assert torch.equal(out, x)
        cot = torch.full_like(x, 3.0)
        assert torch.equal(torch.autograd.grad((out * cot).sum(), var)[0], cot)
        with pytest.raises(NotImplementedError, match="psum has no gradient"):
            dist.psum(var, "rows", mesh)
