"""tests/test_parallel.py on loraine_tpu_torch: the ('blocks', 'schur')
mesh as Gloo CPU ranks, one process each (tests/torch_mesh_worker.py,
launched with a FileStore rendezvous), on a (2, 2) mesh (both axes
sharded: 4 blocks over 2, n = 16 rows over 2) and a (1, 4) mesh (the
schur axis only) in place of the JAX suite's (2, 4). Each JAX test has its
counterpart, sharded against the unsharded port, with the JAX tolerances;
the dd2 step becomes the check that dd2 on a mesh raises
NotImplementedError (ROADMAP item 14b).

Then the seven gates of `loraine_tpu_torch.parallel.dryrun` (the port of
`__graft_entry__.dryrun_multichip`) at 2 and 4 ranks, under the JAX CPU
run's eigen modes (eigh_backend 'mixed', step_eig 'exact'), and each
4-rank sharded objective against the JAX package's unsharded solve of the
same numpy-built problem under the same modes, at the gate's tolerance."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from loraine_tpu.ipm.initial import initial_point
from loraine_tpu.ipm.step import build_step
from loraine_tpu.models.maxcut import maxcut_problem
from loraine_tpu_torch.models.maxcut import maxcut_problem as tmaxcut
from loraine_tpu_torch.ops import schur as tschur
from loraine_tpu_torch.parallel import dryrun, shard_problem
from loraine_tpu_torch.parallel.distributed import launch
from loraine_tpu_torch.parallel.mesh import AXES, Mesh

WORKER = __file__.replace("test_torch_parallel.py", "torch_mesh_worker.py")
SHAPES = ["2,2", "1,4"]
_RUNS = {}


def _parallel(shape, tmp_path_factory):
    """Rank 0's results of every mirrored case on the mesh ``shape`` (the
    values asserted below are replicated: rank 0's stand for all)."""
    if shape not in _RUNS:
        out = tmp_path_factory.mktemp("mesh" + shape.replace(",", "x"))
        launch([WORKER, "parallel", "--out", str(out), "--shape", shape], 4, timeout=400)
        _RUNS[shape] = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    return _RUNS[shape]


def _pair(R, key):
    st_ref, st_sh, obj_ref, obj_sh = R[key]
    return int(st_ref), int(st_sh), obj_ref, obj_sh


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_step_matches_single_device(shape, tmp_path_factory):
    for R in _parallel(shape, tmp_path_factory):
        y_ref, y_sh = R["step_y"]
        np.testing.assert_allclose(y_sh, y_ref, rtol=1e-9, atol=1e-10)
        for key in [k for k in R if k.startswith("step_X")]:
            X_ref, X_sh = R[key]
            np.testing.assert_allclose(X_sh, X_ref, rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(R["step_dimacs"][1], R["step_dimacs"][0], rtol=1e-8)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_full_solve(shape, tmp_path_factory):
    R = _parallel(shape, tmp_path_factory)[0]
    st_ref, st_sh, obj_ref, obj_sh = _pair(R, "full")
    assert st_sh == st_ref == 1
    np.testing.assert_allclose(obj_sh, obj_ref, rtol=1e-8)


@pytest.mark.parametrize("shape", SHAPES)
def test_auto_mesh_shape(shape, tmp_path_factory):
    for R in _parallel(shape, tmp_path_factory):
        blocks, schur = R["auto_shape"]
        assert blocks * schur == 4
        assert (blocks, schur) == (4, 1)  # 4 blocks go around 4 ranks


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_sparse_storage_matches(shape, tmp_path_factory):
    R = _parallel(shape, tmp_path_factory)[0]
    assert bool(R["sparse_all"][0])
    st_ref, st_sh, obj_ref, obj_sh = _pair(R, "sparse")
    assert st_ref == st_sh == 1
    np.testing.assert_allclose(obj_sh, obj_ref, rtol=1e-8)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_initpoint1_preserves_group_norms(shape, tmp_path_factory):
    R = _parallel(shape, tmp_path_factory)[0]
    assert R["norms_kept"].all()
    st_ref, st_sh, obj_ref, obj_sh = _pair(R, "initpoint1")
    assert st_sh == st_ref == 1
    np.testing.assert_allclose(obj_sh, obj_ref, rtol=1e-8)


@pytest.mark.parametrize("shape", SHAPES)
def test_shard_state_preserves_dd2_tails(shape, tmp_path_factory):
    for R in _parallel(shape, tmp_path_factory):
        assert bool(R["dd2_tails"][0])
        np.testing.assert_array_equal(R["dd2_X_lo"][1], R["dd2_X_lo"][0])
        np.testing.assert_array_equal(R["dd2_y_lo"][1], R["dd2_y_lo"][0])
        assert (R["dd2_X_lo"][0] != 0).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_dd2_step_raises_not_ported(shape, tmp_path_factory):
    """The JAX suite's -m slow dd2 step on the mesh: the port's dd tiers do
    not run on a mesh yet, and say so."""
    msg = str(_parallel(shape, tmp_path_factory)[0]["dd2_raises"][0])
    assert "precision='dd2' on a mesh" in msg and "item 14b" in msg


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_full_solve_kit1_halpha(shape, tmp_path_factory):
    R = _parallel(shape, tmp_path_factory)[0]
    st_ref, st_sh, obj_ref, obj_sh = _pair(R, "kit1")
    assert st_ref == st_sh == 1
    # the JAX suite's tolerance: the two CG trajectories stop at different
    # points inside the eDIMACS = 1e-5 band
    np.testing.assert_allclose(obj_sh, obj_ref, rtol=2e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("route", ["kit1_mf", "kit1_hybrid"])
def test_sharded_kit1_other_routes(shape, route, tmp_path_factory):
    """kit=1 on the mesh beyond the JAX suite's case: the matrix-free route
    (cg_materialize='never': the distributed operator and the SMW H_alpha)
    and the hybrid preconditioner 4 (H_beta, then H_alpha), each against
    the unsharded port at the kit=1 test's tolerance."""
    R = _parallel(shape, tmp_path_factory)[0]
    st_ref, st_sh, obj_ref, obj_sh = _pair(R, route)
    assert st_ref == st_sh == 1
    np.testing.assert_allclose(obj_sh, obj_ref, rtol=2e-6)


# ---------------------------------------------------------------------------
# the seven dryrun gates
# ---------------------------------------------------------------------------

_GATES = {}


def _gates(nproc):
    """Every rank's gate records of the dryrun at ``nproc`` ranks; each rank
    asserts its gates itself, so a failed gate fails the launch."""
    if nproc not in _GATES:
        cmd = ["-m", "loraine_tpu_torch.parallel.dryrun", "--device", "cpu", "--modes", "cpu"]
        _GATES[nproc] = dryrun.records(launch(cmd, nproc, timeout=400,
                                              env={"PYTHONPATH": dryrun._ROOT}))
    return _GATES[nproc]


@pytest.mark.parametrize("nproc", [2, 4])
def test_dryrun_gates(nproc):
    recs = _gates(nproc)
    assert sorted({(r["rank"], r["gate"]) for r in recs}) == [
        (r, g) for r in range(nproc) for g in range(1, 8)]
    blocks = 2  # nproc is even: mesh (2, nproc/2), and (1, nproc) for gates 5, 6
    for r in recs:
        assert r["rel"] <= dryrun.TOLS[r["gate"]]
        want = [1, nproc] if r["gate"] in (5, 6) else [blocks, nproc // blocks]
        assert r["mesh"] == want
    tru3 = [r for r in recs if r["gate"] == 1]
    assert all(abs(r["sharded"] - dryrun.TRU3_ANCHOR) < dryrun.TRU3_TOL for r in tru3)
    for g in range(1, 8):  # every rank reports the same sharded value
        vals = {r["sharded"] for r in recs if r["gate"] == g}
        assert len(vals) == 1, (g, vals)


def _jax_reference(gate):
    data = dryrun.gate_data(2)[gate] if gate > 1 else {}
    opts = {**dryrun.GATE_OPTS[gate], **dryrun.CPU_MODES}
    if gate == 1:
        return lt.solve(lt.problem_from_sdpa(dryrun.os.path.join(dryrun.DATA, "tru3.dat-s")),
                        opts).objective, None
    if gate == 6:
        p = maxcut_problem(data["W"], datarank=-1)
        o = lt.Options(**opts).validated()
        _, s = jax.jit(build_step(o, -1))(p, initial_point(p, o), jnp.asarray(1e-2))
        return float(s.obj), {f: float(getattr(s, f)) for f in
                              ("obj", "dimacs", "alpha_min", "beta_min")}
    kw = {k: v for k, v in data.items() if k not in ("As", "Cs", "b")}
    res = lt.solve(lt.problem_from_dense(data["As"], data["Cs"], data["b"], **kw), opts)
    assert res.status == 1
    return res.objective, None


@pytest.mark.parametrize("gate", range(1, 8))
def test_gate_matches_jax_unsharded(gate):
    """The port's sharded objective at 4 ranks against the JAX package's
    unsharded solve (gate 6: its one step's stats) of the same problem."""
    rec = next(r for r in _gates(4) if r["gate"] == gate and r["rank"] == 0)
    obj, stats = _jax_reference(gate)
    assert abs(rec["sharded"] - obj) <= dryrun.TOLS[gate] * max(1.0, abs(obj))
    if stats is not None:
        for f, v in stats.items():
            assert abs(rec["stats"][f] - v) <= dryrun.TOLS[gate] * max(1.0, abs(v)), f


# ---------------------------------------------------------------------------
# in one process: what runs without a collective
# ---------------------------------------------------------------------------


class _NoCollectiveMesh(Mesh):
    """A mesh's shape and coordinates with no process group: any collective
    fails the test."""

    def __init__(self, shape, coords):
        self.shape = dict(zip(AXES, shape))
        self.coords = dict(zip(AXES, coords))

    def reduce(self, *a, **k):
        raise AssertionError("collective called")

    gather = agree = reduce


def _spd(rng, nb, m):
    Q = rng.standard_normal((nb, m, m))
    return Q @ Q.transpose(0, 2, 1) / m + np.eye(m)


def _schur_problems():
    sys.path.insert(0, WORKER.rsplit("/", 1)[0])
    import torch_mesh_worker as w

    rng = np.random.default_rng(11)
    A = np.triu(rng.random((24, 24)) < 0.3, 1).astype(float)
    rank1 = tmaxcut(A + A.T, datarank=-1, device="cpu")
    return {"dense": w.dense_nolp_problem(), "sparse": w.sparse_problem(), "rank1": rank1}


@pytest.mark.parametrize("storage", ["dense", "sparse", "rank1"])
@pytest.mark.parametrize("mixed", [False, True])
def test_row_sharded_schur_rows_need_no_collective(storage, mixed):
    """On a mesh that splits only the rows, each rank's rows of a group's H
    come from its own rows and the column operand `shard_problem` placed
    once (`Shard.cols`): no collective, and the rows of the unsharded H."""
    p = _schur_problems()[storage]
    g = p.groups[0]
    rng = np.random.default_rng(12)
    W = torch.from_numpy(_spd(rng, g.nb, g.m))
    fn = tschur.schur_group_mixed if mixed else tschur.schur_group
    H = fn(g, W, torch.linalg.cholesky(W))
    for k in range(2):
        gs = shard_problem(p, _NoCollectiveMesh((1, 2), (0, k))).groups[0]
        r0, r1 = gs.shard.rows
        assert gs.shard.split_rows and (r0, r1) == (k * p.n // 2, (k + 1) * p.n // 2)
        Hk = fn(gs, W, torch.linalg.cholesky(W))
        assert Hk.shape == (r1 - r0, p.n)
        # the f32 assembly sums in other chunks on a shard: f32 rounding
        tol = 1e-6 if mixed and storage == "dense" else 1e-12
        np.testing.assert_allclose(Hk.numpy(), H[r0:r1].numpy(), rtol=0,
                                   atol=tol * float(H.abs().max()))


@pytest.mark.parametrize("case", ["theta1-kit0", "control1-kit1", "tru3-sparse"])
def test_unsharded_solve_makes_no_collective(case, monkeypatch):
    """Without a mesh the solve reaches no torch.distributed call."""
    def boom(*a, **k):
        raise AssertionError("torch.distributed called without a mesh")

    for name in ("all_reduce", "broadcast"):
        monkeypatch.setattr(torch.distributed, name, boom)
    path, opts = {
        "theta1-kit0": ("theta1", {"kit": 0, "eDIMACS": 1e-6}),
        "control1-kit1": ("control1", {"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5,
                                       "tol_cg_min": 1e-6}),
        "tru3-sparse": ("tru3", {"kit": 0, "eDIMACS": 1e-7, "datasparsity": 64}),
    }[case]
    r = ltt.solve_sdpa(f"{dryrun.DATA}/{path}.dat-s", {**opts, "initpoint": 1, "verb": 0},
                       device="cpu")
    assert r.status == 1
