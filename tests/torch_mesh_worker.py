"""One rank of the mesh tests of tests/test_torch_parallel.py and
tests/test_torch_dist_linalg.py (not a test module). Launched by
`loraine_tpu_torch.parallel.distributed.launch`, which appends
``--rank r --nproc N --init URL``; writes its results as .npz files into
``--out``. Imports no JAX."""
import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import loraine_tpu_torch as ltt  # noqa: E402
from loraine_tpu_torch.ipm.initial import initial_point  # noqa: E402
from loraine_tpu_torch.ipm.step import step  # noqa: E402
from loraine_tpu_torch.ops.dd import DD  # noqa: E402
from loraine_tpu_torch.ops.linalg import chol_blocked, chol_reg, cho_solve_inv, tri_inv  # noqa: E402
from loraine_tpu_torch.models.maxcut import maxcut_problem  # noqa: E402
from loraine_tpu_torch.ops.schur import gather_blocks, schur_group  # noqa: E402
from loraine_tpu_torch.parallel import (auto_mesh, distributed, make_mesh,  # noqa: E402
                                        shard_problem, shard_state)
from loraine_tpu_torch.parallel import dryrun  # noqa: E402

Q = {"verb": 0}


def _solve_pair(problem, mesh, opts):
    ref = ltt.solve(problem, dict(opts), device="cpu")
    res = ltt.solve(shard_problem(problem, mesh), dict(opts), device="cpu")
    return [ref.status, res.status, ref.objective, res.objective]


def case_parallel(shape, out):
    """Every mirrored case of tests/test_parallel.py on one mesh shape."""
    mesh = make_mesh(shape)
    R = {}
    # test_sharded_step_matches_single_device
    problem = dryrun.lp_blocks("cpu")
    opts = ltt.Options(kit=0, verb=0).validated().resolved(problem, "cpu")
    state = initial_point(problem, opts)
    ref_state, ref_stats = step(problem, state, opts)
    sp, ss = shard_problem(problem, mesh), shard_state(state, problem, mesh)
    out_state, out_stats = step(sp, ss, opts)
    R["step_y"] = np.stack([ref_state.y.numpy(), out_state.y.numpy()])
    for gi, (g, Xr, Xs) in enumerate(zip(sp.groups, ref_state.X, out_state.X)):
        R[f"step_X{gi}"] = np.stack([Xr.numpy(), gather_blocks(g, Xs).numpy()])
    R["step_dimacs"] = np.array([float(ref_stats.dimacs), float(out_stats.to_host(mesh)["dimacs"])])
    # test_sharded_full_solve (auto_mesh) and test_auto_mesh_shape
    amesh = auto_mesh(problem)
    R["auto_shape"] = np.array([amesh.shape["blocks"], amesh.shape["schur"]])
    R["full"] = np.array(_solve_pair(problem, amesh, {"kit": 0, "eDIMACS": 1e-7, **Q}))
    # test_sharded_sparse_storage_matches
    sparse = dryrun.sparse_blocks("cpu")
    R["sparse_all"] = np.array([all(g.is_sparse for g in sparse.groups)])
    R["sparse"] = np.array(_solve_pair(sparse, mesh, {"kit": 0, "eDIMACS": 1e-7, **Q}))
    # test_sharded_initpoint1_preserves_group_norms
    sp = shard_problem(problem, mesh)
    R["norms_kept"] = np.array([gs.data_norms == g.data_norms and gs.C_norms == g.C_norms
                                for g, gs in zip(problem.groups, sp.groups)])
    R["initpoint1"] = np.array(_solve_pair(problem, mesh,
                                           {"kit": 0, "eDIMACS": 1e-7, "initpoint": 1, **Q}))
    # test_shard_state_preserves_dd2_tails
    dnl = dryrun.nolp_blocks("cpu")
    o2 = ltt.Options(kit=0, verb=0, precision="dd2", datasparsity=0).validated()
    st2 = ltt.Solver(dnl, o2, device="cpu")._normalize_tails(initial_point(dnl, o2))
    # non-zero tails, so that carrying them is seen
    st2 = dataclasses.replace(st2, X_lo=tuple(torch.full_like(x, 1e-20) for x in st2.X),
                              y_lo=torch.full_like(st2.y, 2e-20))
    ss2 = shard_state(st2, dnl, mesh)
    sp2 = shard_problem(dnl, mesh)
    R["dd2_tails"] = np.array([ss2.X_lo is not None and ss2.S_lo is not None
                               and ss2.y_lo is not None])
    R["dd2_X_lo"] = np.stack([np.concatenate([x.numpy().ravel() for x in st2.X_lo]),
                              np.concatenate([gather_blocks(g, x).numpy().ravel()
                                              for g, x in zip(sp2.groups, ss2.X_lo)])])
    R["dd2_y_lo"] = np.stack([st2.y_lo.numpy(), ss2.y_lo.numpy()])
    # test_sharded_dd2_step_matches_single_device, and the other dd steps
    R.update(dd_steps(mesh))
    # test_sharded_full_solve_kit1_halpha
    R["kit1"] = np.array(_solve_pair(problem, mesh, {"kit": 1, "preconditioner": 1,
                                                     "eDIMACS": 1e-5, "tol_cg_min": 1e-6, **Q}))
    # the matrix-free CG route on the mesh: Aop(W Aadj(x) W) with the
    # collectives, the SMW H_alpha with its V gathered (no JAX counterpart
    # test); and H_beta, the hybrid 4 -> 1, on the materialized route
    for key, extra in (("kit1_mf", {"preconditioner": 1, "cg_materialize": "never"}),
                       ("kit1_hybrid", {"preconditioner": 4})):
        R[key] = np.array(_solve_pair(problem, mesh, {"kit": 1, "eDIMACS": 1e-5,
                                                      "tol_cg_min": 1e-6, **extra, **Q}))
    np.savez(os.path.join(out, f"rank{distributed.rank()}.npz"), **R)


def dd_steps(mesh):
    """One step of each `dryrun.DD_STEPS` case, unsharded and on ``mesh``
    (`dryrun.dd_step_pair`), under the keys "<case>.<field>"."""
    return {f"{key}.{k}": v for key in dryrun.DD_STEPS
            for k, v in dryrun.dd_step_pair(key, mesh, "cpu").items()}


def case_reduce_dd(out):
    """`Mesh.reduce_dd` over 'schur' on the (1, N) mesh and over 'blocks' on
    the (N, 1) mesh, of seeded partials with live low words; every rank's
    partials are made from the same seed, so each rank also returns all."""
    nproc, rank = distributed.world_size(), distributed.rank()
    rng = np.random.default_rng(21)
    hi = rng.standard_normal((nproc, 5, 3)) * 10.0 ** rng.integers(-3, 4, (nproc, 5, 3))
    lo = hi * 2.0**-60 * rng.standard_normal(hi.shape)
    R = {"hi": hi, "lo": lo}
    for shape, axis in (((1, nproc), "schur"), ((nproc, 1), "blocks")):
        mesh = make_mesh(shape)
        x = DD(torch.from_numpy(hi[rank]), torch.from_numpy(lo[rank]))
        r = mesh.reduce_dd(x, axis)
        R[axis] = np.stack([r.hi.numpy(), r.lo.numpy()])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **R)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def indefinite(n, seed):
    """Block-diagonal: a 200 x 200 block with one eigenvalue at -2.5e-4
    (the rest in [1, 10]), then an SPD block. Its Cholesky first fails in
    the second panel's diagonal block (row 199), and three 1e-4 shifts make
    it positive definite."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((200, 200)))[0]
    lam = np.linspace(1.0, 10.0, 200)
    lam[0] = -2.5e-4
    M = np.zeros((n, n))
    M[:200, :200] = (Q * lam) @ Q.T
    M[200:, 200:] = _spd(n - 200, seed)
    return (M + M.T) / 2


def case_linalg(out):
    """Distributed chol_blocked / tri_inv / cho_solve_inv at n = 160 and
    300, and chol_reg and the NaN pattern on an indefinite matrix."""
    nproc = distributed.world_size()
    mesh = make_mesh((1, nproc))
    R = {}
    for n in (160, 300):
        M = torch.tensor(_spd(n, n))
        r0, r1, split = mesh.split(n, "schur")
        L = chol_blocked(M[r0:r1], mesh)
        Li = tri_inv(L, mesh)
        b = torch.tensor(np.random.default_rng(n + 1).standard_normal(n))
        R[f"L{n}"], R[f"Li{n}"] = L.numpy(), Li.numpy()
        R[f"x{n}"] = cho_solve_inv(Li, b, mesh).numpy()
        R[f"rows{n}"] = np.array([r0, r1, split])
    n = 300
    M = torch.tensor(indefinite(n, 5))
    r0, r1, _ = mesh.split(n, "schur")
    R["Lnan"] = chol_blocked(M[r0:r1], mesh).numpy()
    hc = chol_reg(M[r0:r1], 1e-4, 1000, mesh=mesh)
    R["reg"] = np.array([hc.shifts, hc.ok])
    R["Lreg"] = hc.L.numpy()
    np.savez(os.path.join(out, f"rank{distributed.rank()}.npz"), **R)


def case_int8(out):
    """The rank-1 Schur rows under gemm_backend='int8' on the (1, N) mesh
    (max-cut data, 24 nodes; W and G from a seed), and a solve sharded and
    unsharded under gemm_backend='int8' with chol_backend='mixed'."""
    nproc = distributed.world_size()
    mesh = make_mesh((1, nproc))
    rng = np.random.default_rng(11)
    A = np.triu(rng.random((24, 24)) < 0.3, 1).astype(float)
    problem = maxcut_problem(A + A.T, datarank=-1, device="cpu")
    g = problem.groups[0]
    Z = np.random.default_rng(12).standard_normal((g.nb, g.m, g.m))
    W = torch.from_numpy(Z @ Z.transpose(0, 2, 1) / g.m + np.eye(g.m))
    gs = shard_problem(problem, mesh).groups[0]
    R = {"W": W.numpy(), "rows": np.array(gs.shard.rows),
         "H": schur_group(gs, W, torch.linalg.cholesky(W), "int8").numpy(),
         "solve": np.array(_solve_pair(problem, mesh, {"kit": 0, "eDIMACS": 1e-7,
                                                       "gemm_backend": "int8",
                                                       "chol_backend": "mixed", **Q}))}
    np.savez(os.path.join(out, f"rank{distributed.rank()}.npz"), **R)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=("parallel", "linalg", "reduce_dd", "int8"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--shape", default="2,2")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--init", required=True)
    a = ap.parse_args()
    torch.set_num_threads(1)
    distributed.initialize(a.init, a.nproc, a.rank, backend="gloo", device="cpu", timeout_s=240)
    if a.case == "parallel":
        case_parallel(tuple(int(s) for s in a.shape.split(",")), a.out)
    elif a.case == "reduce_dd":
        case_reduce_dd(a.out)
    elif a.case == "int8":
        case_int8(a.out)
    else:
        case_linalg(a.out)
    distributed.shutdown()


if __name__ == "__main__":
    main()
