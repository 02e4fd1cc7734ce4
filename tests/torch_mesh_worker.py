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
from loraine_tpu_torch.ops.linalg import chol_blocked, chol_reg, cho_solve_inv, tri_inv  # noqa: E402
from loraine_tpu_torch.ops.schur import gather_blocks  # noqa: E402
from loraine_tpu_torch.parallel import (auto_mesh, distributed, make_mesh,  # noqa: E402
                                        shard_problem, shard_state)

Q = {"verb": 0}


def multiblock_problem():
    """tests/test_parallel.py `_multiblock_problem`, on the CPU."""
    rng = np.random.default_rng(0)
    nb, n, m, nlin = 4, 16, 8, 4
    As, Cs = [], []
    for _ in range(nb):
        A = rng.standard_normal((n, m, m))
        As.append((A + A.transpose(0, 2, 1)) / 2)
        C = rng.standard_normal((m, m))
        Cs.append(C @ C.T + m * np.eye(m))
    b = rng.standard_normal(n)
    C_lin = rng.standard_normal((n, nlin))
    d_lin = np.abs(rng.standard_normal(nlin)) + 1.0
    return ltt.problem_from_dense(As, Cs, b, C_lin=C_lin, d_lin=d_lin, device="cpu")


def sparse_problem():
    """tests/test_parallel.py `test_sharded_sparse_storage_matches`'s data."""
    rng = np.random.default_rng(4)
    nb, n, m = 4, 16, 8
    As = []
    for _ in range(nb):
        A = np.zeros((n, m, m))
        for j in range(n):
            r, c = rng.integers(0, m, 2)
            v = rng.standard_normal()
            A[j, r, c] += v
            A[j, c, r] += v * (r != c)
        As.append(A)
    Cs = [np.eye(m) * (m + i) for i in range(nb)]
    b = rng.standard_normal(n)
    return ltt.problem_from_dense(As, Cs, b, storage="sparse", device="cpu")


def dense_nolp_problem():
    """tests/test_parallel.py `_dense_noLP_problem`."""
    rng = np.random.default_rng(7)
    nb, n, m = 4, 12, 6
    As, Cs = [], []
    for _ in range(nb):
        A = rng.standard_normal((n, m, m))
        As.append((A + A.transpose(0, 2, 1)) / 2)
        C = rng.standard_normal((m, m))
        Cs.append(C @ C.T + m * np.eye(m))
    b = rng.standard_normal(n)
    return ltt.problem_from_dense(As, Cs, b, storage="dense", device="cpu")


def _solve_pair(problem, mesh, opts):
    ref = ltt.solve(problem, dict(opts), device="cpu")
    res = ltt.solve(shard_problem(problem, mesh), dict(opts), device="cpu")
    return [ref.status, res.status, ref.objective, res.objective]


def case_parallel(shape, out):
    """Every mirrored case of tests/test_parallel.py on one mesh shape."""
    mesh = make_mesh(shape)
    R = {}
    # test_sharded_step_matches_single_device
    problem = multiblock_problem()
    opts = ltt.Options(kit=0, verb=0).validated()
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
    sparse = sparse_problem()
    R["sparse_all"] = np.array([all(g.is_sparse for g in sparse.groups)])
    R["sparse"] = np.array(_solve_pair(sparse, mesh, {"kit": 0, "eDIMACS": 1e-7, **Q}))
    # test_sharded_initpoint1_preserves_group_norms
    sp = shard_problem(problem, mesh)
    R["norms_kept"] = np.array([gs.data_norms == g.data_norms and gs.C_norms == g.C_norms
                                for g, gs in zip(problem.groups, sp.groups)])
    R["initpoint1"] = np.array(_solve_pair(problem, mesh,
                                           {"kit": 0, "eDIMACS": 1e-7, "initpoint": 1, **Q}))
    # test_shard_state_preserves_dd2_tails
    dnl = dense_nolp_problem()
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
    # test_sharded_dd2_step_matches_single_device: dd2 on a mesh is item 14b
    try:
        ltt.Solver(sp2, o2, device="cpu")
        R["dd2_raises"] = np.array([""])
    except NotImplementedError as e:
        R["dd2_raises"] = np.array([str(e)])
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=("parallel", "linalg"))
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
    else:
        case_linalg(a.out)
    distributed.shutdown()


if __name__ == "__main__":
    main()
