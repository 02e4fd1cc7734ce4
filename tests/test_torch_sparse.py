"""Sparse COO storage of loraine_tpu_torch against the JAX package, on the CPU.

The storage decision, the padded COO arrays, the sparse contractions (Aop,
Aadj, the chunked gather Schur assembly `_schur_sparse`), the sparse
t-columns of H_alpha, one step and whole solves of forced-sparse tru3 and
vib3 (kit=0, and kit=1 on the materialized and matrix-free routes). The
port's sparse Aadj sums over a per-cell layout (`problem.AdjLayout`) where
the JAX package scatter-adds, so the two agree to rounding, not bit for bit.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from loraine_tpu.ops import nt_scaling as jnt, precond as jprec, schur as jschur
from loraine_tpu_torch.convert import problem_from_numpy
from loraine_tpu_torch.ops import precond as tprec, schur as tschur
from loraine_tpu_torch.ops.nt_scaling import NTScaling
from loraine_tpu_torch.problem import pick_storage
from torch_cases import (EXACT_MODES, PALLAS_MODES, assert_same_step, errs_agree,
                         solve_pair, step_both)

DATA = pathlib.Path(__file__).parent / "data"
TRU3 = str(DATA / "tru3.dat-s")
SPARSE = {"datasparsity": 64}  # an explicit nnz threshold: tru3 goes sparse
# the option sets of test_torch_lp.py
K0 = {"kit": 0, "eDIMACS": 1e-7, "initpoint": 1, "verb": 0}
K1 = {"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-6,
      "initpoint": 1, "verb": 0}
K1_TIGHT = dict(K1, tol_cg=1e-10, tol_cg_min=1e-10)

# tests/test_sparse_path.py:120-141: file -> (n, per-block (m0, smax), decision)
SHIPPED = {
    "theta1": (104, [(50, 50)], "dense"),
    "control1": (21, [(5, 2), (10, 36)], "dense"),
    "tru3": (36, [(13, 16)], "dense"),
    "vib3": (36, [(12, 16), (13, 16)], "dense"),
    "tru9": (3240, [(145, 16)], "sparse"),
    "vib9": (3240, [(144, 16), (145, 16)], "sparse"),
    "maxG11": (800, [(800, 1)], "sparse"),
    "thetaG11": (2401, [(801, 9)], "sparse"),
}


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_storage_decisions_reproduce_shipped(name):
    """pick_storage on the parsed stats, and the loader's default choice on
    the file itself (maxG11 and thetaG11 take the > max_dense_gb branch)."""
    n, stats, expected = SHIPPED[name]
    assert pick_storage(n, stats) == expected
    p = ltt.load_problem(str(DATA / f"{name}.dat-s"), device="cpu")
    assert p.n == n
    assert [g.is_sparse for g in p.groups] == [expected == "sparse"] * len(p.groups)
    if expected == "sparse":
        assert max(g.Avals.shape[-1] for g in p.groups) == max(s for _, s in stats)


def assert_same_sparse_problem(pt, pj):
    assert (pt.n, pt.nlin, pt.nlmi, pt.sum_msizes) == (pj.n, pj.nlin, pj.nlmi, pj.sum_msizes)
    assert len(pt.groups) == len(pj.groups)
    for gt, gj in zip(pt.groups, pj.groups):
        assert (gt.m, gt.nb, gt.orig_indices, gt.is_sparse) == (gj.m, gj.nb, gj.orig_indices, True)
        assert gt.data_norms == gj.data_norms and gt.C_norms == gj.C_norms
        assert gt.A is None and gt.Arows.dtype == torch.int64
        for name in ("C", "Arows", "Acols", "Avals"):
            np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)))


@pytest.mark.parametrize("name,opts", [
    ("tru3", SPARSE),
    ("vib3", SPARSE),
    ("control1", {"datasparsity": 1000}),
    ("tru9", {}),
    ("vib9", {}),
])
def test_sparse_problem_matches_jax(name, opts):
    pj = lt.load_problem(str(DATA / f"{name}.dat-s"), opts)
    pt = ltt.load_problem(str(DATA / f"{name}.dat-s"), opts, device="cpu")
    assert_same_sparse_problem(pt, pj)
    if name == "vib9":  # m 152 and 144 do not merge (m_max > 128)
        assert [(g.m, g.nb) for g in pt.groups] == [(144, 1), (152, 1)]


def _sparse_random(seed=0, nb=2, n=40, m=12, nnz=3, shared_cell=False):
    """tests/test_sparse_path.py:_sparse_random; with ``shared_cell`` every
    A_j also holds entry (0, 0), so one cell collects n entries."""
    rng = np.random.default_rng(seed)
    As = []
    for _ in range(nb):
        A = np.zeros((n, m, m))
        for j in range(n):
            for _ in range(nnz):
                r, c = rng.integers(0, m, 2)
                v = rng.standard_normal()
                A[j, r, c] += v
                if r != c:
                    A[j, c, r] += v
            if shared_cell:
                A[j, 0, 0] += 1.0 + rng.random()
        As.append(A)
    Cs = []
    for _ in range(nb):
        C = rng.standard_normal((m, m))
        Cs.append(C @ C.T + m * np.eye(m))
    return As, Cs, rng.standard_normal(n)


@pytest.mark.parametrize("case", ["one_chunk", "shared_cell", "two_chunks"])
def test_sparse_contractions_match_jax_and_dense(case):
    """Aop, Aadj and the Schur assembly on sparse storage against JAX's
    sparse storage and the port's dense storage of the same data. In the
    two-chunk case J = 2^25 // (nb n s) = 406 < n = 700, so `_schur_sparse`
    runs the JAX chunk rule with a short last chunk."""
    kw = {"one_chunk": {}, "shared_cell": {"shared_cell": True},
          "two_chunks": {"n": 700, "nnz": 30, "seed": 2}}[case]
    As, Cs, b = _sparse_random(**kw)
    pj = lt.problem_from_dense(As, Cs, b, storage="sparse", pad_multiple=4)
    pt = ltt.problem_from_dense(As, Cs, b, storage="sparse", pad_multiple=4, device="cpu")
    pd = ltt.problem_from_dense(As, Cs, b, storage="dense", pad_multiple=4, device="cpu")
    (gj,), (gt,), (gd,) = pj.groups, pt.groups, pd.groups
    assert gt.is_sparse and not gd.is_sparse
    nb, n, s = gt.Avals.shape
    J = min(n, max(8, (1 << 25) // (nb * n * s)))
    assert (J < n) == (case == "two_chunks") and n % J in (0, 700 - 406)
    if case == "shared_cell":
        assert gt.adj.rows.shape[-1] > 1  # the (0, 0) cell spans several rows

    rng = np.random.default_rng(1)
    W = rng.standard_normal((gt.nb, gt.m, gt.m))
    W = W @ W.transpose(0, 2, 1) + gt.m * np.eye(gt.m)
    y = rng.standard_normal(n)
    Wt, yt = torch.from_numpy(W), torch.from_numpy(y)
    Gt = torch.linalg.cholesky(Wt)
    outs = {
        "Aop": (tschur.Aop(gt, Wt), jschur.Aop(gj, jnp.asarray(W)), tschur.Aop(gd, Wt)),
        "Aadj": (tschur.Aadj(gt, yt), jschur.Aadj(gj, jnp.asarray(y)), tschur.Aadj(gd, yt)),
        "schur": (tschur.schur_group(gt, Wt, Gt),
                  jschur.schur_group(gj, jnp.asarray(W), jnp.asarray(Gt.numpy())),
                  tschur.schur_group(gd, Wt, Gt)),
    }
    for name, (t, j, d) in outs.items():
        scale = np.abs(np.asarray(j)).max()
        for ref in (np.asarray(j), d.numpy()):
            np.testing.assert_allclose(t.numpy(), ref, rtol=1e-12, atol=1e-12 * scale,
                                       err_msg=name)


def test_sparse_adjoint_is_the_scatter_sum():
    # the per-cell layout against the scatter-add it replaces, in f64 numpy
    As, Cs, b = _sparse_random(seed=9, shared_cell=True)
    (g,) = ltt.problem_from_dense(As, Cs, b, storage="sparse", device="cpu").groups
    y = np.random.default_rng(5).standard_normal(g.Avals.shape[1])
    rows, cols, vals = g.Arows.numpy(), g.Acols.numpy(), g.Avals.numpy()
    ref = np.zeros((g.nb, g.m, g.m))
    for bb in range(g.nb):
        np.add.at(ref[bb], (rows[bb].ravel(), cols[bb].ravel()), (vals[bb] * y[:, None]).ravel())
    out = tschur.Aadj(g, torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-13 * np.abs(ref).max())


@pytest.fixture(scope="module")
def tru3_sparse_mid():
    """Forced-sparse tru3 at JAX's kit=0 iterate 5, with JAX's NT scaling
    and LP weight on both sides, and the port's dense-storage problem."""
    pj = lt.load_problem(TRU3, SPARSE)
    mid = lt.solve(pj, dict(K0, **PALLAS_MODES, maxit=5)).final_state
    ntj = tuple(jnt.nt_scale(X, S, eigh_backend="pallas") for X, S in zip(mid.X, mid.S))
    lpw_j = jschur.lp_weight(mid.X_lin, 1.0 / mid.S_lin)
    ntt = tuple(
        NTScaling(*(torch.from_numpy(np.array(f)) if np.ndim(f) else bool(f) for f in nt))
        for nt in ntj
    )
    pt = problem_from_numpy(jax.device_get(pj), device="cpu")
    pd = ltt.load_problem(TRU3, device="cpu")
    return pj, ntj, lpw_j, pt, pd, ntt, torch.from_numpy(np.array(lpw_j))


@pytest.mark.parametrize("materialize", [False, True])
def test_sparse_alpha_precond_matches_jax_and_dense(tru3_sparse_mid, materialize):
    """H_alpha's sparse t-columns (Z^T A_j U by gathers), on the same NT
    scaling: against JAX's sparse storage and the port's dense storage."""
    pj, ntj, lpw_j, pt, pd, ntt, lpw_t = tru3_sparse_mid
    assert pt.groups[0].is_sparse and not pd.groups[0].is_sparse
    aj = jprec.prep_alpha(pj, ntj, lpw_j, 1, 1, "pallas", materialize=materialize)
    at = tprec.prep_alpha(pt, ntt, lpw_t, 1, 1, "pallas", materialize=materialize)
    ad = tprec.prep_alpha(pd, ntt, lpw_t, 1, 1, "pallas", materialize=materialize)
    if materialize:
        fj, ft, fd = aj.apply, at.apply, ad.apply
    else:
        fj = lambda v: aj.apply_with(pj, v)  # noqa: E731
        ft, fd = (lambda v: at.apply_with(pt, v)), (lambda v: ad.apply_with(pd, v))
    for v in np.random.default_rng(8).standard_normal((3, pt.n)):
        zj = np.asarray(fj(jnp.asarray(v)))
        vt = torch.from_numpy(v)
        for z in (ft(vt).numpy(), fd(vt).numpy()):
            assert np.abs(z - zj).max() <= 1e-12 * np.abs(zj).max()


@pytest.mark.parametrize("name,opts", [
    ("tru3", K0),
    ("tru3", K1),
    # the matrix-free route: pcg on Aop(W Aadj(x) W) + C_lin diag(lpw) C_lin^T x
    # with the sparse Aop/Aadj, preconditioned by the SMW H_alpha
    ("tru3", dict(K1, cg_materialize="never")),
    ("vib3", dict(K1, cg_materialize="never")),
])
def test_sparse_step_from_jax_state_matches(name, opts):
    pj = lt.load_problem(str(DATA / f"{name}.dat-s"), dict(opts, **SPARSE))
    assert all(g.is_sparse for g in pj.groups)
    mid = lt.solve(pj, dict(opts, **PALLAS_MODES, maxit=5)).final_state
    j, t = step_both(pj, mid, opts)
    assert_same_step(j, t)
    if opts["kit"] == 1:
        assert int(t[1].cg_iter_pre) > 0


@pytest.mark.parametrize("opts", [K0, K1])
def test_sparse_tru3_solve_matches_jax(opts):
    """Forced-sparse tru3 through `solve_sdpa`, against JAX's sparse solve and
    the port's dense one. kit=0: same iterations, objective within 1e-7,
    err1..err6 within 1e-4 per iteration while DIMACS > 1e-4 (the f32
    Jacobi seeds, measured <= 3.6e-5); kit=1: the chaotic CG counts of
    test_torch_lp.py, one iteration of slack, the objective within 1e-7
    where the counts agree and eDIMACS where they do not."""
    o = dict(opts, **SPARSE)
    rj = lt.solve_sdpa(TRU3, dict(o, **PALLAS_MODES))
    rt = ltt.solve_sdpa(TRU3, o, device="cpu")
    rd = ltt.solve_sdpa(TRU3, opts, device="cpu")
    assert rt.status == rj.status == rd.status == 1
    if opts["kit"] == 0:
        assert rt.iterations == rj.iterations == rd.iterations
        for r in (rj, rd):
            assert abs(rt.objective - r.objective) <= 1e-7 * abs(r.objective)
        errs_agree(rj, rt, 1e-4)
    else:
        assert abs(rt.iterations - rj.iterations) <= 1
        rtol = 1e-7 if rt.iterations == rj.iterations else opts["eDIMACS"]
        assert abs(rt.objective - rj.objective) <= rtol * abs(rj.objective)
        assert rt.cg_iterations > 0


@pytest.mark.parametrize("name,route", [
    ("tru3", "auto"),  # materialized
    ("tru3", "never"),  # matrix-free: pcg with the sparse Aop/Aadj, SMW H_alpha
    ("vib3", "never"),
])
def test_sparse_kit1_tight_solve_matches_jax(name, route):
    """Forced-sparse kit=1 solves with the CG taken to 1e-10 (K1_TIGHT of
    test_torch_lp.py), per iteration as there: same iterations, objective
    within 1e-7, err1..err6 within 1e-4 on the port's path (measured
    <= 6.3e-5) and 1e-6 under exact bounds (measured <= 7.2e-9)."""
    o = dict(K1_TIGHT, cg_materialize=route, **SPARSE)
    for modes, rtol in ((PALLAS_MODES, 1e-4), (EXACT_MODES, 1e-6)):
        rj, rt = solve_pair(str(DATA / f"{name}.dat-s"), o, modes)
        assert rt.status == rj.status == 1 and rt.iterations == rj.iterations
        assert abs(rt.objective - rj.objective) <= 1e-7 * abs(rj.objective)
        errs_agree(rj, rt, rtol, atol=K1_TIGHT["tol_cg_min"])
        assert rt.cg_iterations > 0
