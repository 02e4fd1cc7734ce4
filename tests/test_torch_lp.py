"""The LP cone of loraine_tpu_torch against the JAX package, on the CPU.

SDPLIB tru3 (n=36, one 13x13 block, 72 LP variables) and vib3 (n=36, blocks
13 and 12 in one group of 2 x 16, 72 LP variables), and a synthetic
two-group problem with an LP cone. The building blocks (`lp_weight`,
`schur_lp`, the LP initial point, the LP terms of H_alpha / H_beta) take
the same inputs on both sides. One step from the same JAX iterate is held
under EXACT_MODES (torch_cases.py), the whole solves under PALLAS_MODES,
the port's own path, and per iteration under EXACT_MODES too.
"""
import contextlib
import dataclasses
import pathlib
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from loraine_tpu.ipm.initial import initial_point as jax_initial_point
from loraine_tpu.ops import nt_scaling as jnt, precond as jprec, schur as jschur
from loraine_tpu_torch.convert import problem_from_numpy
from loraine_tpu_torch.io.sdpa import read_sdpa
from loraine_tpu_torch.ipm.initial import initial_point
from loraine_tpu_torch.ops import precond as tprec, schur as tschur
from loraine_tpu_torch.ops.nt_scaling import NTScaling
from torch_cases import (EXACT_MODES, PALLAS_MODES, assert_same_step, errs_agree,
                         solve_pair, step_both)

DATA = pathlib.Path(__file__).parent / "data"
K0 = {"kit": 0, "eDIMACS": 1e-7, "initpoint": 1, "verb": 0}
# bench.py:77-79 (control1-cg)
K1 = {"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-6,
      "initpoint": 1, "verb": 0}
# K1 with every CG solve taken to 1e-10: the stop then falls on the steep
# tail of the residual curve, not on the plateau that makes K1's counts
# chaotic (see test_kit1_solve_matches_jax)
K1_TIGHT = dict(K1, tol_cg=1e-10, tol_cg_min=1e-10)


def _path(name):
    return str(DATA / f"{name}.dat-s")


def test_lp_weight_and_schur_lp_match_jax():
    rng = np.random.default_rng(0)
    C_lin = rng.standard_normal((30, 50))
    X, S = rng.uniform(0.1, 2.0, 50), rng.uniform(0.1, 2.0, 50)
    wj = jschur.lp_weight(jnp.asarray(X), 1.0 / jnp.asarray(S))
    wt = tschur.lp_weight(torch.from_numpy(X), 1.0 / torch.from_numpy(S))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-12)
    Hj = np.asarray(jschur.schur_lp(jnp.asarray(C_lin), wj))
    Ht = tschur.schur_lp(torch.from_numpy(C_lin), wt).numpy()
    np.testing.assert_allclose(Ht, Hj, rtol=1e-12, atol=1e-12 * np.abs(Hj).max())
    np.testing.assert_allclose(Ht, (C_lin * X / S) @ C_lin.T, rtol=1e-12,
                               atol=1e-12 * np.abs(Hj).max())


@pytest.mark.parametrize("name", ["tru3", "vib3"])
@pytest.mark.parametrize("initpoint", [0, 1])
def test_lp_problem_and_initial_point_match_jax(name, initpoint):
    pj = lt.load_problem(_path(name))
    pt = ltt.load_problem(_path(name), device="cpu")
    assert pt.nlin == pj.nlin == 72 and pt.C_lin.shape == (36, 72)
    np.testing.assert_array_equal(pt.C_lin.numpy(), np.asarray(pj.C_lin))
    np.testing.assert_array_equal(pt.d_lin.numpy(), np.asarray(pj.d_lin))
    assert pt.sum_msizes == pj.sum_msizes
    opts = {"initpoint": initpoint}
    sj = jax_initial_point(pj, lt.Options.from_dict(opts).validated())
    st = initial_point(pt, ltt.Options.from_dict(opts).validated())
    for a, b in zip(st.X + st.S + (st.y, st.X_lin, st.S_lin),
                    sj.X + sj.S + (sj.y, sj.X_lin, sj.S_lin)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_problem_from_dense_with_lp_matches_jax():
    rng = np.random.default_rng(4)
    A = rng.standard_normal((5, 6, 6))
    A = A + A.transpose(0, 2, 1)
    C_lin, d_lin = rng.standard_normal((5, 3)), rng.uniform(1, 2, 3)
    args = ([A], [np.eye(6) * 6], rng.standard_normal(5), C_lin, d_lin)
    pj = lt.problem_from_dense(*args)
    pt = ltt.problem_from_dense(*args, device="cpu")
    assert pt.nlin == pj.nlin == 3 and pt.sum_msizes == pj.sum_msizes
    np.testing.assert_array_equal(pt.C_lin.numpy(), C_lin)
    np.testing.assert_array_equal(pt.d_lin.numpy(), d_lin)


@pytest.fixture(scope="module")
def tru3_mid():
    """(JAX problem, JAX NT scaling, JAX lpw, port problem, the same NT
    scaling and lpw as torch tensors) at tru3's kit=0 iterate 5."""
    pj = lt.load_problem(_path("tru3"))
    mid = lt.solve(pj, dict(K0, **PALLAS_MODES, maxit=5)).final_state
    ntj = tuple(jnt.nt_scale(X, S, eigh_backend="pallas") for X, S in zip(mid.X, mid.S))
    lpw_j = jschur.lp_weight(mid.X_lin, 1.0 / mid.S_lin)
    pt = problem_from_numpy(jax.device_get(pj), device="cpu")
    ntt = tuple(
        NTScaling(*(torch.from_numpy(np.array(f)) if np.ndim(f) else bool(f) for f in nt))
        for nt in ntj
    )
    lpw_t = torch.from_numpy(np.array(lpw_j))
    return pj, ntj, lpw_j, pt, ntt, lpw_t


@pytest.mark.parametrize("kind", ["beta", "alpha_smw", "alpha_dense"])
@pytest.mark.parametrize("aamat", [0, 1])
def test_lp_precond_matches_jax(tru3_mid, kind, aamat):
    """H_beta and H_alpha with the LP block on a tru3 iterate: both sides
    start from JAX's NT scaling, so only library f64 calls (eigh of W,
    Cholesky) differ. Compared by their action on seeded vectors."""
    pj, ntj, lpw_j, pt, ntt, lpw_t = tru3_mid
    if kind == "beta":
        aj = jprec.prep_beta(pj, ntj, lpw_j, 1, aamat, "pallas")
        at = tprec.prep_beta(pt, ntt, lpw_t, 1, aamat, "pallas")
        np.testing.assert_allclose(at.diag.numpy(), np.asarray(aj.diag), rtol=1e-12)
        fj, ft = aj.apply, at.apply
    elif kind == "alpha_smw":
        aj = jprec.prep_alpha(pj, ntj, lpw_j, 1, aamat, "pallas")
        at = tprec.prep_alpha(pt, ntt, lpw_t, 1, aamat, "pallas")
        assert at.lp_chol is not None
        fj, ft = (lambda v: aj.apply_with(pj, v)), (lambda v: at.apply_with(pt, v))
    else:
        aj = jprec.prep_alpha(pj, ntj, lpw_j, 1, aamat, "pallas", materialize=True)
        at = tprec.prep_alpha(pt, ntt, lpw_t, 1, aamat, "pallas", materialize=True)
        fj, ft = aj.apply, at.apply
    for v in np.random.default_rng(7).standard_normal((3, pt.n)):
        zj = np.asarray(fj(jnp.asarray(v)))
        zt = ft(torch.from_numpy(v)).numpy()
        assert np.abs(zt - zj).max() <= 1e-12 * np.abs(zj).max()


def test_lp_smw_and_materialized_alpha_agree(tru3_mid):
    # with the LP block, SMW solves through chol(AAAATtau) and the dense
    # route factors AAAATtau + t t^T: the same H_alpha^{-1} up to rounding
    _, _, _, pt, ntt, lpw = tru3_mid
    smw = tprec.prep_alpha(pt, ntt, lpw, 2, 1)
    dense = tprec.prep_alpha(pt, ntt, lpw, 2, 1, materialize=True)
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(pt.n))
    a, b = smw.apply_with(pt, v), dense.apply(v)
    assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())


@pytest.mark.parametrize("name,opts", [
    ("tru3", K0),
    ("vib3", K0),
    ("vib3", K1),
])
def test_one_step_from_jax_state_matches(name, opts):
    pj = lt.load_problem(_path(name))
    mid = lt.solve(pj, dict(opts, **PALLAS_MODES, maxit=5)).final_state
    j, t = step_both(pj, mid, opts)
    assert_same_step(j, t)
    assert t[0].X_lin.shape == (72,) and bool((t[0].X_lin > 0).all())


def _two_group_problem(seed=3):
    """Blocks of 130 and 6 (padded 136 and 8: over 128, so the buckets stay
    two groups), n = 6 constraints and 5 LP variables, feasible at y = 0."""
    rng = np.random.default_rng(seed)
    n, As, Cs = 6, [], []
    for m in (130, 6):
        A = rng.standard_normal((n, m, m))
        As.append((A + A.transpose(0, 2, 1)) / 2)
        C = rng.standard_normal((m, m))
        Cs.append(C @ C.T / m + np.eye(m))
    return As, Cs, rng.standard_normal(n), rng.standard_normal((n, 5)), rng.uniform(1, 2, 5)


def test_two_group_step_matches_jax():
    As, Cs, b, C_lin, d_lin = _two_group_problem()
    pj = lt.problem_from_dense(As, Cs, b, C_lin, d_lin)
    assert [(g.m, g.nb) for g in pj.groups] == [(8, 1), (136, 1)]
    s0 = jax_initial_point(pj, lt.Options.from_dict(K0).validated())
    j, t = step_both(pj, s0, K0)
    assert_same_step(j, t)


@pytest.fixture(scope="module")
def solves():
    """Whole solves of each package per (case, options, modes)."""
    runs = (("K0", "pallas"), ("K0", "exact"), ("K1", "pallas"),
            ("K1_TIGHT", "pallas"), ("K1_TIGHT", "exact"))
    opts = {"K0": K0, "K1": K1, "K1_TIGHT": K1_TIGHT}
    modes = {"pallas": PALLAS_MODES, "exact": EXACT_MODES}
    return {(name, o, m): solve_pair(_path(name), opts[o], modes[m])
            for name in ("tru3", "vib3") for o, m in runs}


@pytest.mark.parametrize("name", ["tru3", "vib3"])
def test_kit0_solve_matches_jax(solves, name):
    # the port's path: the f32 Jacobi seeds reach the trajectory through
    # the steplength bounds (measured <= 3.7e-5 relative on err1..err6)
    rj, rt = solves[name, "K0", "pallas"]
    assert rt.status == rj.status == 1
    assert rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= 1e-7 * abs(rj.objective)
    errs_agree(rj, rt, 1e-4)
    assert abs(rt.dual_objective - rj.dual_objective) <= 1e-7 * abs(rj.dual_objective)
    np.testing.assert_allclose(rt.X_lin, rj.X_lin, rtol=1e-4, atol=1e-9)
    # exact spectral bounds on both sides: the rest of the f64 arithmetic
    # agrees per iteration to rounding (measured <= 2.9e-9 relative)
    rj, rt = solves[name, "K0", "exact"]
    assert rt.status == rj.status == 1 and rt.iterations == rj.iterations
    errs_agree(rj, rt, 1e-6)


@pytest.mark.parametrize("name", ["tru3", "vib3"])
def test_kit1_solve_matches_jax(solves, name):
    # With K1 the early CG solves stop at tol_cg = 1e-2, and there the
    # unpreconditioned residual of CG oscillates about the threshold (vib3's
    # first corrector solve: 0.0101 at 12 CG iterations, 0.0110-0.0266 at
    # 13-18, 0.0023 at 19), so the count, and with it the trajectory, turns
    # on the last bits. Measured: a relative change of 1e-14 of b (6 seeds)
    # gives vib3 in 14-17 IPM iterations in the JAX package and in the port
    # alike; on the same perturbed b the two agree in 3 of 6 (objectives
    # equal in all 10 printed digits). So the count is held to one
    # iteration, the objective to 1e-7 where the counts agree (measured:
    # tru3 10 = 10, 3.5e-8) and to eDIMACS where they do not (vib3 14 vs
    # 15, 1.1e-6). The per-iteration errors are held on K1_TIGHT, where the
    # counts are stable.
    rj, rt = solves[name, "K1", "pallas"]
    assert rt.status == rj.status == 1
    assert abs(rt.iterations - rj.iterations) <= 1
    rtol = 1e-7 if rt.iterations == rj.iterations else K1["eDIMACS"]
    assert abs(rt.objective - rj.objective) <= rtol * abs(rj.objective)
    assert rt.dimacs < K1["eDIMACS"] and rt.cg_iterations > 0


@pytest.mark.parametrize("name", ["tru3", "vib3"])
def test_kit1_tight_solve_matches_jax(solves, name):
    """The kit=1 path per iteration: same iteration count, objectives within
    1e-7, err1..err6 within 1e-4 on the port's path (the f32 Jacobi seeds,
    measured <= 3.1e-5) and 1e-6 under exact bounds (measured <= 3.6e-9)
    while DIMACS > 1e-4. The absolute 1e-10 is the CG tolerance: once the
    iterate is feasible err1 sits at the inexact Newton solve's residual."""
    for modes, rtol in (("pallas", 1e-4), ("exact", 1e-6)):
        rj, rt = solves[name, "K1_TIGHT", modes]
        assert rt.status == rj.status == 1 and rt.iterations == rj.iterations
        assert abs(rt.objective - rj.objective) <= 1e-7 * abs(rj.objective)
        errs_agree(rj, rt, rtol, atol=K1_TIGHT["tol_cg_min"])
        assert rt.cg_iterations > 0


def test_vib3_objective_and_blocks(solves):
    # tests/test_ipm_e2e.py:63-70: two PSD blocks of different sizes + LP
    for opts in ("K0", "K1"):
        rj, rt = solves["vib3", opts, "pallas"]
        np.testing.assert_allclose(rt.objective, 0.1027087, rtol=1e-4)
        assert [X.shape for X in rt.X] == [X.shape for X in rj.X] == [(13, 13), (12, 12)]
        assert rt.X_lin.shape == (72,) and bool((rt.X_lin > 0).all())


@pytest.mark.parametrize("kit", [0, 1])
def test_pure_lp_matches_jax(kit):
    """No LMI block (nlmi = 0, `loraine_tpu.models.lp`): the LP cone alone.
    kit=1 falls back to the direct solver, as in the JAX package. Same
    arithmetic on both sides (no Jacobi kernel runs): iterations equal,
    objectives within 1e-12."""
    rng = np.random.default_rng(0)
    C = rng.standard_normal((5, 12))
    b = C @ rng.uniform(0.5, 1.5, 12)
    d = C.T @ rng.standard_normal(5) + rng.uniform(0.5, 1.0, 12)
    opts = dict(K0, kit=kit)
    with pytest.warns(UserWarning, match="no LMIs") if kit else contextlib.nullcontext():
        rt = ltt.solve(ltt.problem_from_dense([], [], b, C, d, device="cpu"), opts, device="cpu")
    rj = lt.solve(lt.problem_from_dense([], [], b, C, d), dict(opts, **PALLAS_MODES))
    assert rt.status == rj.status == 1 and rt.iterations == rj.iterations
    assert rt.X == [] and rt.cg_iterations == 0
    for a, c in ((rt.objective, rj.objective), (rt.dual_objective, rj.dual_objective)):
        assert abs(a - c) <= 1e-12 * abs(c)
    np.testing.assert_allclose(rt.X_lin, rj.X_lin, rtol=1e-10, atol=1e-14)


# ---------------------------------------------------------------------------
# The LP cone from SDPA entries (`problem.py:lp_cone`) and the initial point
# from the build's host norms
# ---------------------------------------------------------------------------

# n = 3, a 2x2 LMI block and two LP blocks (3 and 2 columns): constraint 1
# has four LP nonzeros (three in the first block), constraint 2 a
# duplicated entry, constraint 3 a pair that cancels to an explicit 0.0
SYNTHETIC = """\
* two LP blocks, a duplicated entry, a row with three or more nonzeros
3
3
2 -3 -2
1.0 2.0 3.0
0 1 1 1 1.0
0 1 2 2 1.0
1 1 1 2 0.5
2 1 1 1 1.0
3 1 2 2 -1.0
0 2 1 1 1.5
0 2 2 2 2.0
0 2 3 3 1.0
1 2 1 1 0.1
1 2 2 2 -0.7
1 2 3 3 1.3
2 2 2 2 0.25
2 2 2 2 0.1
3 2 1 1 0.5
3 2 1 1 -0.5
0 3 1 1 1.0
0 3 2 2 3.0
1 3 1 1 0.9
2 3 1 1 1e-3
3 3 2 2 -2.2
"""
LP_CASES = ["tru3", "vib3", "tru9", "synthetic"]


@pytest.fixture(scope="module")
def lp_cases(tmp_path_factory):
    """name -> (parsed SDPA data, the port's problem on the CPU)."""
    synthetic = tmp_path_factory.mktemp("lp") / "synthetic.dat-s"
    synthetic.write_text(SYNTHETIC)
    out = {}
    for name in LP_CASES:
        data = read_sdpa(str(synthetic) if name == "synthetic" else _path(name))
        out[name] = data, ltt.problem_from_sdpa(data, device="cpu")
    return out


def _dense_lp(data):
    """C_lin and d_lin as `problem_from_sdpa` built them densely: `np.add.at`
    into a zeroed [n, nlin] per LP block, the blocks concatenated."""
    Cs, ds = [], []
    for bs, (mat, row, col, val) in zip(data.block_sizes, data.blocks):
        if bs < 0:
            C, d, f0 = np.zeros((data.nvar, -bs)), np.zeros(-bs), mat == 0
            np.add.at(d, row[f0], -val[f0])
            np.add.at(C, (mat[~f0] - 1, row[~f0]), -val[~f0])
            Cs.append(C)
            ds.append(d)
    return np.concatenate(Cs, axis=1), np.concatenate(ds)


def _formula_initial_point(problem, C_lin, d_lin):
    """The initpoint=1 start (`src/initial_point.jl:17-81`) from the device
    b and a dense host C_lin, with `np.linalg.norm` of its rows."""
    b2 = 1.0 + np.abs(problem.b.numpy())
    norm_b2 = float(np.linalg.norm(b2))
    X, S = [], []
    for g in problem.groups:
        m = g.m
        f = norm_b2 / (1.0 + np.asarray(g.data_norms))
        eps = np.sqrt(m) * np.maximum(1.0, np.sqrt(m) * f)
        mf = (1.0 + np.maximum(f, np.asarray(g.C_norms))) / np.sqrt(m)
        eta = np.sqrt(m) * np.maximum(1.0, mf)
        X.append(eps[:, None, None] * np.eye(m)[None])
        S.append(eta[:, None, None] * np.eye(m)[None])
    row_norms = np.linalg.norm(C_lin, axis=1)
    epss = max(1.0, float((b2 / (1.0 + row_norms)).max()))
    mf = max(float(row_norms.max()), float(np.linalg.norm(d_lin)))
    etaa = max(1.0, mf / np.sqrt(C_lin.shape[1]))
    return X, S, np.full(C_lin.shape[1], epss), np.full(C_lin.shape[1], etaa)


@pytest.mark.parametrize("name", LP_CASES)
def test_sdpa_lp_cone_equals_the_dense_construction(lp_cases, name):
    """(a) The LP cone built from SDPA entries on the device is the dense
    `np.add.at` construction bit for bit: duplicates summed in entry order,
    the columns of several LP blocks side by side."""
    data, pt = lp_cases[name]
    C_lin, d_lin = _dense_lp(data)
    assert pt.nlin == C_lin.shape[1] and pt.C_lin.dtype == torch.float64
    np.testing.assert_array_equal(pt.C_lin.numpy(), C_lin)
    np.testing.assert_array_equal(pt.d_lin.numpy(), d_lin)
    np.testing.assert_array_equal(pt.b_host, pt.b.numpy())
    if name == "synthetic":
        assert np.count_nonzero(C_lin, axis=1).max() >= 3 and C_lin[2, 0] == 0.0


@pytest.mark.parametrize("name,exact", [("tru9", True), ("synthetic", False)])
def test_initial_point_from_build_norms_matches_the_dense_formula(lp_cases, name, exact):
    """(b) `initial_point` from the build's host norms against the formula
    over the dense rows: bit for bit where every row of C_lin has at most
    two nonzeros (tru9: numpy's pairwise sum and the bincount both give
    fl(a^2 + b^2)), to 1e-15 relative where a row has more."""
    data, pt = lp_cases[name]
    if exact:
        assert np.count_nonzero(pt.C_lin.numpy(), axis=1).max() <= 2
    X, S, X_lin, S_lin = _formula_initial_point(pt, *_dense_lp(data))
    st = initial_point(pt, ltt.Options.from_dict({"initpoint": 1}).validated())
    for got, want in zip(st.X + st.S + (st.y, st.X_lin, st.S_lin),
                         X + S + [np.zeros(pt.n), X_lin, S_lin]):
        if exact:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("name", LP_CASES)
@pytest.mark.parametrize("initpoint", [0, 1])
def test_initial_point_reads_no_device_lp_data(lp_cases, name, initpoint):
    """(c) The same start when C_lin and d_lin live on the 'meta' device,
    which holds no values: `initial_point` reads only the build's host
    values."""
    _, pt = lp_cases[name]
    blind = dataclasses.replace(pt, C_lin=torch.empty(pt.C_lin.shape, device="meta"),
                                d_lin=torch.empty(pt.d_lin.shape, device="meta"))
    opts = ltt.Options.from_dict({"initpoint": initpoint}).validated()
    a, b = initial_point(pt, opts), initial_point(blind, opts)
    for x, y in zip(a.X + a.S + (a.y, a.X_lin, a.S_lin, a.sigma),
                    b.X + b.S + (b.y, b.X_lin, b.S_lin, b.sigma)):
        assert torch.equal(x, y)


def test_sdpa_build_allocates_no_dense_host_lp_cone(lp_cases):
    """(d) tru9's build from parsed data traces under 40 MB of host (numpy)
    allocations at its peak; the dense [3240, 6480] float64 C_lin alone was
    168 MB."""
    data, _ = lp_cases["tru9"]
    tracemalloc.start()
    try:
        pt = ltt.problem_from_sdpa(data, device="cpu")
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert pt.C_lin.shape == (3240, 6480)
    assert peak < 40e6, f"{peak / 1e6:.1f} MB"
