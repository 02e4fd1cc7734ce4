"""tests/test_hard_tail.py on loraine_tpu_torch: the same cases and
assertions, word for word, on the port with device='cpu' under the JAX CPU
run's modes (eigh_backend 'jacobi' below m = 192, 'mixed' from there;
step_eig 'exact'), the modes in which the JAX suite passes. `lt` here is
`torch_cases.PORT_CPU`, which serves the suite's calls from the port.

One case more, `test_redundant_sum_constraint_kernel_modes`: the port under
its own 'auto' (eigh_backend and step_eig 'pallas', the plain versions of
B1 and B2 here) against the JAX package under the same modes (its Pallas
kernels in interpret mode): both end with status 3 after 8 iterations
(>5 Schur regularizations: H is singular at every iterate of this problem
by construction), DIMACS within 1e-4 relative.
"""
import numpy as np
import pytest

import loraine_tpu
import loraine_tpu_torch as ltt
from test_conformance import _check_kkt, _random_feasible_sdp
from torch_cases import PORT_CPU as lt, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

Q = {"verb": 0}


def _maxby(res, b):
    """b^T y at the solution (the raw dual-form objective)."""
    return float(np.dot(b, res.y))


# ---------------------------------------------------------------------------
# degenerate objectives / data the reference's exclusion list documents
# ---------------------------------------------------------------------------

def test_blank_objective():
    # b = 0: every feasible y is optimal. The reference fails this class
    # (PosDefException on `test_objective_ObjectiveFunction_blank`).
    A = np.eye(3)[None]
    prob = lt.problem_from_dense([A], [np.eye(3)], np.zeros(1))
    res = lt.solve(prob, Q)
    assert res.status == 1
    assert abs(_maxby(res, np.zeros(1))) < 1e-8
    assert float(res.y[0]) <= 1 + 1e-6  # feasibility: y <= 1


def test_zero_data_block_plus_lp():
    # an LMI block whose data matrices are all zero (S = C fixed), with the
    # binding constraint in the LP cone: max y s.t. 0*y <= I, y <= 1
    A = np.zeros((1, 3, 3))
    prob = lt.problem_from_dense(
        [A], [np.eye(3)], np.array([1.0]),
        C_lin=np.array([[1.0]]), d_lin=np.array([1.0]),
    )
    res = lt.solve(prob, Q)
    assert res.status == 1
    np.testing.assert_allclose(res.y, [1.0], atol=1e-6)


def test_zero_C_boundary_optimum():
    # max y s.t. y*I <= 0: optimum y*=0 sits exactly on the cone boundary
    # (S* = 0, no strictly feasible dual slack at the optimum)
    A = np.eye(3)[None]
    prob = lt.problem_from_dense([A], [np.zeros((3, 3))], np.array([1.0]))
    res = lt.solve(prob, {**Q, "eDIMACS": 1e-6})
    assert res.status == 1
    assert abs(float(res.y[0])) < 1e-5


def test_negative_definite_C():
    # min y s.t. y >= 1 in PSD form: max (-1)*y, -y*I <= -I
    A = -np.eye(2)[None]
    prob = lt.problem_from_dense([A], [-np.eye(2)], np.array([-1.0]))
    res = lt.solve(prob, Q)
    assert res.status == 1
    np.testing.assert_allclose(res.y, [1.0], rtol=1e-6)


# ---------------------------------------------------------------------------
# redundancy / duplication (singular Schur complement H)
# ---------------------------------------------------------------------------

def test_duplicate_constraint_matrices():
    # A1 == A2 makes H exactly singular (rank 1); the regularization path
    # (reference `src/predictor_corrector.jl:59-88`) must still converge to
    # the well-defined optimal value y1+y2 = 1.
    A = np.eye(3)[None]
    prob = lt.problem_from_dense([np.concatenate([A, A])], [np.eye(3)],
                                 np.array([1.0, 1.0]))
    res = lt.solve(prob, {**Q, "eDIMACS": 1e-6})
    assert res.status == 1
    np.testing.assert_allclose(float(res.y[0] + res.y[1]), 1.0, atol=1e-5)


def test_duplicate_constraints_kit1():
    # the same singular-H degeneracy through the CG path: the H_alpha
    # preconditioner and PCG must survive an exactly singular operator
    A = np.eye(3)[None]
    prob = lt.problem_from_dense([np.concatenate([A, A])], [np.eye(3)],
                                 np.array([1.0, 1.0]))
    res = lt.solve(prob, {**Q, "kit": 1, "preconditioner": 1, "eDIMACS": 1e-5})
    assert res.status == 1
    np.testing.assert_allclose(float(res.y[0] + res.y[1]), 1.0, atol=1e-4)


def test_redundant_sum_constraint():
    # A3 = A1 + A2 with b3 = b1 + b2: consistent but dual-degenerate
    # (y non-unique along (1,1,-1)); the optimal value is still unique
    rng = np.random.default_rng(3)
    A1 = rng.standard_normal((5, 5));  A1 = A1 + A1.T
    A2 = rng.standard_normal((5, 5));  A2 = A2 + A2.T
    As = np.stack([A1, A2, A1 + A2])
    y0 = np.array([0.1, -0.2, 0.05])
    S0 = rng.standard_normal((5, 5)); S0 = S0 @ S0.T + 5 * np.eye(5)
    C = np.einsum("j,jpq->pq", y0, As) + S0
    Z = rng.standard_normal((5, 5)); X0 = Z @ Z.T + 5 * np.eye(5)
    b = np.einsum("jpq,pq->j", As, X0)
    # the whole optimal face is a line (y + t(1,1,-1) stays optimal), so H
    # is singular at EVERY iterate: the regularization give-up (reference
    # `src/predictor_corrector.jl:64-72`, >5 regs -> status 3) fires by
    # design. The reference's exclusion list documents outright Cholesky
    # *crashes* on this class; we require graceful termination with an
    # accurate final iterate instead of an exception
    prob3 = lt.problem_from_dense([As], [C], b)
    res3 = lt.solve(prob3, {**Q, "eDIMACS": 5e-4, "maxit": 60})
    assert res3.status in (1, 3)
    assert res3.dimacs < 1e-3  # made it to the degeneracy floor, no blow-up
    # the 2-variable problem with y3 eliminated (y1' = y1+y3, y2' = y2+y3)
    prob2 = lt.problem_from_dense([As[:2]], [C], b[:2])
    res2 = lt.solve(prob2, {**Q, "eDIMACS": 1e-6})
    assert res2.status == 1
    # same optimal value iff b3 = b1+b2 consistency holds
    np.testing.assert_allclose(_maxby(res3, b), _maxby(res2, b[:2]),
                               rtol=1e-3)


def test_duplicate_lp_rows():
    # y <= 1 stated twice: LP-cone duplicate rows, H_lin rank-deficient
    prob = lt.problem_from_dense(
        [], [], np.array([1.0]),
        C_lin=np.array([[1.0, 1.0]]), d_lin=np.array([1.0, 1.0]),
    )
    res = lt.solve(prob, Q)
    assert res.status == 1
    np.testing.assert_allclose(res.y, [1.0], atol=1e-6)


def test_equality_via_paired_lp_rows():
    # y1 + y2 == 1 encoded as paired inequalities (the ZerosBridge class the
    # reference must exclude), plus box rows; optimum y = (0.6, 0.4)
    C_lin = np.array([
        [1.0, -1.0, 1.0, 0.0],
        [1.0, -1.0, 0.0, 1.0],
    ])
    d_lin = np.array([1.0, -1.0, 0.6, 0.8])
    prob = lt.problem_from_dense([], [], np.array([1.0, 0.0]),
                                 C_lin=C_lin, d_lin=d_lin)
    res = lt.solve(prob, {**Q, "eDIMACS": 1e-7})
    assert res.status == 1
    np.testing.assert_allclose(res.y, [0.6, 0.4], atol=1e-5)


# ---------------------------------------------------------------------------
# rank-deficient / strict-complementarity-degenerate optima
# ---------------------------------------------------------------------------

def test_rank_deficient_optimum():
    # max y s.t. y*I <= diag(1,2,3): y* = 1, X* is the rank-1 projector on
    # e1 (tr X = b = 1); the IPM must converge with X* rank-deficient
    A = np.eye(3)[None]
    prob = lt.problem_from_dense([A], [np.diag([1.0, 2.0, 3.0])],
                                 np.array([1.0]))
    res = lt.solve(prob, {**Q, "eDIMACS": 1e-8})
    assert res.status == 1
    np.testing.assert_allclose(res.y, [1.0], rtol=1e-7)
    w = np.linalg.eigvalsh(res.X[0])
    np.testing.assert_allclose(w[-1], 1.0, atol=1e-5)   # top eigenvalue
    assert abs(w[-2]) < 1e-5                            # rank deficiency


def test_primal_dual_both_singular():
    # max y s.t. y*e11 <= diag(0,1): y* = 0, S* = diag(0,1) singular AND
    # X* = diag(1,0) singular — degenerate corner
    A = np.zeros((1, 2, 2)); A[0, 0, 0] = 1.0
    prob = lt.problem_from_dense([A], [np.diag([0.0, 1.0])], np.array([1.0]))
    res = lt.solve(prob, {**Q, "eDIMACS": 1e-7})
    assert res.status == 1
    assert abs(float(res.y[0])) < 1e-5
    np.testing.assert_allclose(res.X[0][0, 0], 1.0, atol=1e-4)


def test_offdiagonal_single_var():
    # n=1 with indefinite data: y*[[0,1],[1,0]] <= I means |y| <= 1
    A = np.array([[[0.0, 1.0], [1.0, 0.0]]])
    prob = lt.problem_from_dense([A], [np.eye(2)], np.array([1.0]))
    res = lt.solve(prob, Q)
    assert res.status == 1
    np.testing.assert_allclose(res.y, [1.0], rtol=1e-6)


# ---------------------------------------------------------------------------
# infeasibility / unboundedness certification (reference conflates these
# with ITERATION_LIMIT — its exclusion list `test_linear_DUAL_INFEASIBLE*`)
# ---------------------------------------------------------------------------

def test_infeasible_psd_certified():
    # y <= -1 and y >= 1 simultaneously: primal (SDPA-sense) infeasible
    A = np.diag([1.0, -1.0])[None]
    prob = lt.problem_from_dense([A], [-np.eye(2)], np.array([1.0]))
    res = lt.solve(prob, {**Q, "maxit": 100})
    assert res.status in (2, 3), res.status_name


def test_infeasible_zero_operator():
    # 0*y <= -I: no y works at all
    prob = lt.problem_from_dense([np.zeros((1, 4, 4))], [-np.eye(4)],
                                 np.array([1.0]))
    res = lt.solve(prob, {**Q, "maxit": 100})
    assert res.status in (2, 3), res.status_name


def test_infeasible_lp_only():
    # y <= 0 and -y <= -1
    prob = lt.problem_from_dense(
        [], [], np.array([1.0]),
        C_lin=np.array([[1.0, -1.0]]), d_lin=np.array([0.0, -1.0]),
    )
    res = lt.solve(prob, {**Q, "maxit": 100})
    assert res.status in (2, 3), res.status_name


def test_unbounded_certified():
    # max y s.t. -y*I <= I: y >= -1, unbounded above
    prob = lt.problem_from_dense([-np.eye(3)[None]], [np.eye(3)],
                                 np.array([1.0]))
    res = lt.solve(prob, {**Q, "maxit": 100})
    assert res.status in (2, 3), res.status_name


def test_unbounded_lp_only():
    # max y1+y2 s.t. y1 - y2 <= 1: recession direction (1,1)
    prob = lt.problem_from_dense(
        [], [], np.array([1.0, 1.0]),
        C_lin=np.array([[1.0], [-1.0]]), d_lin=np.array([1.0]),
    )
    res = lt.solve(prob, {**Q, "maxit": 100})
    assert res.status in (2, 3), res.status_name


def test_iteration_limit_status():
    data = _random_feasible_sdp(11)
    As, Cs, b, C_lin, d_lin = data
    prob = lt.problem_from_dense(As, Cs, b, C_lin=C_lin, d_lin=d_lin)
    res = lt.solve(prob, {**Q, "maxit": 2, "eDIMACS": 1e-12})
    assert res.status == 4
    assert res.iterations == 2


# ---------------------------------------------------------------------------
# cone mixtures / shape corners
# ---------------------------------------------------------------------------

def test_lp_only_problem():
    # zero PSD blocks entirely: max y1+y2 s.t. y1<=1, y2<=2, y1+y2<=2.5
    C_lin = np.array([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]])
    d_lin = np.array([1.0, 2.0, 2.5])
    b = np.array([1.0, 1.0])
    prob = lt.problem_from_dense([], [], b, C_lin=C_lin, d_lin=d_lin)
    res = lt.solve(prob, {**Q, "eDIMACS": 1e-7})
    assert res.status == 1
    np.testing.assert_allclose(_maxby(res, b), 2.5, rtol=1e-6)
    # primal feasibility of the LP multipliers: C_lin @ x = b
    np.testing.assert_allclose(C_lin @ res.X_lin, b, atol=1e-5)


def test_1x1_block_plus_lp():
    # PSD 1x1 block y <= 3 plus binding LP row y <= 2
    prob = lt.problem_from_dense(
        [np.ones((1, 1, 1))], [np.array([[3.0]])], np.array([1.0]),
        C_lin=np.array([[1.0]]), d_lin=np.array([2.0]),
    )
    res = lt.solve(prob, Q)
    assert res.status == 1
    np.testing.assert_allclose(res.y, [2.0], rtol=1e-6)
    # the 1x1 slack is inactive: X block ~ 0, LP multiplier carries b
    np.testing.assert_allclose(res.X_lin, [1.0], atol=1e-5)


def test_mixed_block_sizes_with_lp():
    # blocks m=1,3,7 + LP rows, strictly feasible by construction
    rng = np.random.default_rng(5)
    n = 6
    y0 = rng.standard_normal(n) * 0.1
    As, Cs = [], []
    for m in (1, 3, 7):
        A = rng.standard_normal((n, m, m))
        A = (A + A.transpose(0, 2, 1)) / 2
        S0 = rng.standard_normal((m, m)); S0 = S0 @ S0.T + m * np.eye(m)
        As.append(A)
        Cs.append(np.einsum("j,jpq->pq", y0, A) + S0)
    C_lin = rng.standard_normal((n, 2))
    d_lin = C_lin.T @ y0 + 1.0
    b = np.zeros(n)
    for A in As:
        Z = rng.standard_normal(A.shape[1:]); X0 = Z @ Z.T + np.eye(A.shape[1])
        b += np.einsum("jpq,pq->j", A, X0)
    b += C_lin @ (1.0 + rng.random(2))
    prob = lt.problem_from_dense(As, Cs, b, C_lin=C_lin, d_lin=d_lin)
    res = lt.solve(prob, {**Q, "eDIMACS": 1e-7})
    assert res.status == 1
    _check_kkt((As, Cs, b, C_lin, d_lin), res, 1e-6)


def test_diagonal_lmi_equals_lp():
    # diagonal SDP == LP: solving the same data as a diagonal LMI and as
    # LP-cone rows must agree
    rng = np.random.default_rng(9)
    n, k = 4, 6
    Cmat = rng.standard_normal((n, k))
    y0 = rng.standard_normal(n) * 0.1
    d = Cmat.T @ y0 + 1.0 + rng.random(k)
    b = Cmat @ (1.0 + rng.random(k))
    As = np.stack([np.diag(Cmat[j]) for j in range(n)])
    prob_lmi = lt.problem_from_dense([As], [np.diag(d)], b)
    prob_lp = lt.problem_from_dense([], [], b, C_lin=Cmat, d_lin=d)
    r1 = lt.solve(prob_lmi, {**Q, "eDIMACS": 1e-7})
    r2 = lt.solve(prob_lp, {**Q, "eDIMACS": 1e-7})
    assert r1.status == 1 and r2.status == 1
    np.testing.assert_allclose(_maxby(r1, b), _maxby(r2, b), rtol=1e-6)


# ---------------------------------------------------------------------------
# scaling pathologies
# ---------------------------------------------------------------------------

def test_badly_scaled_constraints():
    # rescaling (A_j, ) by s_j rescales y_j by 1/s_j but preserves the
    # optimal value of b_scaled = s .* b ... with y_j' = y_j/s_j giving the
    # same b'y. The solver must handle 1e6 dynamic range in the data.
    data = _random_feasible_sdp(13, nlin=0)
    As, Cs, b, _, _ = data
    s = np.ones(b.shape[0]); s[0] = 1e6; s[1] = 1e-6
    As_s = [A * s[:, None, None] for A in As]
    b_s = b * s
    r0 = lt.solve(lt.problem_from_dense(As, Cs, b), {**Q, "eDIMACS": 1e-7})
    r1 = lt.solve(lt.problem_from_dense(As_s, Cs, b_s), {**Q, "eDIMACS": 1e-7})
    assert r0.status == 1 and r1.status == 1
    np.testing.assert_allclose(_maxby(r1, b_s), _maxby(r0, b), rtol=1e-5)


def test_objective_scale_invariance():
    # scaling b scales the objective but not the argmax
    data = _random_feasible_sdp(17, nlin=0)
    As, Cs, b, _, _ = data
    r0 = lt.solve(lt.problem_from_dense(As, Cs, b), {**Q, "eDIMACS": 1e-7})
    r1 = lt.solve(lt.problem_from_dense(As, Cs, 1e-6 * b), {**Q, "eDIMACS": 1e-7})
    assert r0.status == 1 and r1.status == 1
    np.testing.assert_allclose(r1.y, r0.y, rtol=1e-3, atol=1e-4)


def test_zero_entries_in_b():
    data = _random_feasible_sdp(19, nlin=0)
    As, Cs, b, _, _ = data
    b = b.copy(); b[::2] = 0.0
    prob = lt.problem_from_dense(As, Cs, b)
    res = lt.solve(prob, {**Q, "eDIMACS": 1e-7})
    assert res.status == 1
    _check_kkt((As, Cs, b, None, None), res, 1e-6)


# ---------------------------------------------------------------------------
# rank-one compression corners
# ---------------------------------------------------------------------------

def test_rank1_mixed_sign_factors():
    # A_j = +/- u u': the compression must carry signs (the reference's
    # factors are always positive, `src/makeBBBB.jl:1-20`)
    rng = np.random.default_rng(23)
    m, n = 6, 4
    us = rng.standard_normal((n, m))
    sgn = np.array([1.0, -1.0, 1.0, -1.0])
    As = np.stack([sgn[j] * np.outer(us[j], us[j]) for j in range(n)])
    y0 = rng.standard_normal(n) * 0.1
    S0 = rng.standard_normal((m, m)); S0 = S0 @ S0.T + m * np.eye(m)
    C = np.einsum("j,jpq->pq", y0, As) + S0
    Z = rng.standard_normal((m, m)); X0 = Z @ Z.T + np.eye(m)
    b = np.einsum("jpq,pq->j", As, X0)
    r_dense = lt.solve(lt.problem_from_dense([As], [C], b, datarank=0),
                       {**Q, "eDIMACS": 1e-7})
    r_rank1 = lt.solve(lt.problem_from_dense([As], [C], b, datarank=-1),
                       {**Q, "eDIMACS": 1e-7})
    assert r_dense.status == 1 and r_rank1.status == 1
    np.testing.assert_allclose(_maxby(r_rank1, b), _maxby(r_dense, b),
                               rtol=1e-6)


def test_rank1_guard_fallback():
    # data that is NOT rank-1 under datarank=-1 must fall back to dense
    # (reference guard 5e-6, `src/model.jl:189-191` / `src/Solvers.jl:435-444`)
    data = _random_feasible_sdp(29, nb=1, nlin=0)
    As, Cs, b, _, _ = data
    import warnings as _w
    with _w.catch_warnings():
        _w.simplefilter("ignore")
        prob = lt.problem_from_dense(As, Cs, b, datarank=-1)
    res = lt.solve(prob, {**Q, "eDIMACS": 1e-7})
    assert res.status == 1
    _check_kkt((As, Cs, b, None, None), res, 1e-6)


def test_redundant_sum_constraint_kernel_modes():
    # test_redundant_sum_constraint's 3-variable problem under the port's
    # 'auto' (the Jacobi kernels' plain versions here) against the JAX
    # package under the same modes (Pallas interpret mode): both give up
    # after the sixth Schur regularization, at the same iterate
    rng = np.random.default_rng(3)
    A1 = rng.standard_normal((5, 5));  A1 = A1 + A1.T
    A2 = rng.standard_normal((5, 5));  A2 = A2 + A2.T
    As = np.stack([A1, A2, A1 + A2])
    y0 = np.array([0.1, -0.2, 0.05])
    S0 = rng.standard_normal((5, 5)); S0 = S0 @ S0.T + 5 * np.eye(5)
    C = np.einsum("j,jpq->pq", y0, As) + S0
    Z = rng.standard_normal((5, 5)); X0 = Z @ Z.T + 5 * np.eye(5)
    b = np.einsum("jpq,pq->j", As, X0)
    opts = {**Q, "eDIMACS": 5e-4, "maxit": 60, "eigh_backend": "pallas", "step_eig": "pallas"}
    rj = loraine_tpu.solve(loraine_tpu.problem_from_dense([As], [C], b), opts)
    rt = ltt.solve(ltt.problem_from_dense([As], [C], b, device="cpu"), opts, device="cpu")
    assert rj.status == rt.status == 3
    assert rj.iterations == rt.iterations == 8
    assert abs(rt.dimacs - rj.dimacs) <= 1e-4 * rj.dimacs
