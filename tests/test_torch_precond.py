"""The H_alpha / H_beta preconditioners of loraine_tpu_torch against the JAX
package's, and the preconditioner kinds of the CG path end to end.

Both packages build the preconditioners from the same IPM iterate (JAX's,
carried across with `convert.py`): a theta1 state (dense data) and a
40-node max-cut state (rank-1 data). Each side computes its own NT scaling
(eigh_backend='pallas'; f32 Jacobi seeds under f64 refinement, equal to
~1e-12) and then the preconditioner, whose eigendecompositions are library
f64 calls on both sides. Top eigenvalues of W may be degenerate, which
makes U basis-dependent, so the preconditioners are compared by their
action on seeded vectors: within 1e-10 relative.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from loraine_tpu.io.sdpa import SDPAData as JaxSDPAData
from loraine_tpu.ops import nt_scaling as jnt, precond as jprec
from loraine_tpu.problem import problem_from_sdpa as jax_problem_from_sdpa
from loraine_tpu_torch.convert import problem_from_numpy, state_from_numpy
from loraine_tpu_torch.ops import nt_scaling as tnt, precond as tprec
from torch_cases import maxcut_sdpa

DATA = pathlib.Path(__file__).parent / "data"
JAX_MODES = {"eigh_backend": "pallas", "step_eig": "pallas", "cg_kernel": "xla"}


@pytest.fixture(scope="module")
def states():
    """(JAX problem, JAX NT scalings, port problem, port NT scalings) at a
    mid-solve iterate (5 kit=0 iterations) of theta1 and of a rank-1 max-cut."""
    out = {}
    for name, pj in (
        ("dense", lt.load_problem(str(DATA / "theta1.dat-s"))),
        ("rank1", jax_problem_from_sdpa(maxcut_sdpa(cls=JaxSDPAData), datarank=-1)),
    ):
        mid = lt.solve(pj, dict(JAX_MODES, kit=0, initpoint=1, verb=0, maxit=5)).final_state
        pt = problem_from_numpy(jax.device_get(pj), device="cpu")
        st = state_from_numpy(jax.device_get(mid), device="cpu")
        ntj = tuple(jnt.nt_scale(X, S, eigh_backend="pallas") for X, S in zip(mid.X, mid.S))
        ntt = tuple(tnt.nt_scale(X, S) for X, S in zip(st.X, st.S))
        out[name] = (pj, ntj, pt, ntt)
    return out


@pytest.mark.parametrize("aamat", [0, 1])
@pytest.mark.parametrize("kind", ["beta", "alpha_smw", "alpha_dense"])
@pytest.mark.parametrize("case", ["dense", "rank1"])
def test_precond_action_matches_jax(states, case, kind, aamat):
    pj, ntj, pt, ntt = states[case]
    V = np.random.default_rng(11).standard_normal((3, pt.n))
    if kind == "beta":
        aj = jprec.prep_beta(pj, ntj, None, 1, aamat, "pallas")
        at = tprec.prep_beta(pt, ntt, None, 1, aamat, "pallas")
        fj, ft = aj.apply, at.apply
    elif kind == "alpha_smw":
        aj = jprec.prep_alpha(pj, ntj, None, 1, aamat, "pallas")
        at = tprec.prep_alpha(pt, ntt, None, 1, aamat, "pallas")
        fj, ft = (lambda v: aj.apply_with(pj, v)), (lambda v: at.apply_with(pt, v))
    else:
        aj = jprec.prep_alpha(pj, ntj, None, 1, aamat, "pallas", materialize=True)
        at = tprec.prep_alpha(pt, ntt, None, 1, aamat, "pallas", materialize=True)
        fj, ft = aj.apply, at.apply
        assert isinstance(at, tprec.AlphaPrecondDense)
    for v in V:
        zj = np.asarray(fj(jnp.asarray(v)))
        zt = ft(torch.from_numpy(v)).numpy()
        assert np.abs(zt - zj).max() <= 1e-10 * np.abs(zj).max()


def test_smw_and_materialized_alpha_agree(states):
    # the two routes apply the same operator H_alpha^{-1} up to rounding
    _, _, pt, ntt = states["dense"]
    smw = tprec.prep_alpha(pt, ntt, None, 2, 1)
    dense = tprec.prep_alpha(pt, ntt, None, 2, 1, materialize=True)
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(pt.n))
    a, b = smw.apply_with(pt, v), dense.apply(v)
    assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())


def test_lp_terms_raise(states):
    """The LP terms once raised NotImplementedError. Now H_beta's diagonal is
    s + (C_lin^2) lpw, as in the JAX package: here on theta1's state with an
    LP cone of 3 seeded columns attached to both problems."""
    pj, ntj, pt, ntt = states["dense"]
    lpw = np.random.default_rng(2).uniform(0.5, 2.0, 3)
    C_lin = np.random.default_rng(3).standard_normal((pt.n, 3))
    pj = dataclasses.replace(pj, C_lin=jnp.asarray(C_lin), d_lin=jnp.ones(3), nlin=3)
    pt2 = dataclasses.replace(pt, C_lin=torch.from_numpy(C_lin),
                              d_lin=torch.ones(3, dtype=torch.float64), nlin=3)
    s = tprec.prep_beta(pt, ntt, None, 1, 1).diag
    d = tprec.prep_beta(pt2, ntt, torch.from_numpy(lpw), 1, 1).diag
    np.testing.assert_allclose(d.numpy(), s.numpy() + (C_lin**2) @ lpw, rtol=1e-14)
    dj = jprec.prep_beta(pj, ntj, jnp.asarray(lpw), 1, 1, "pallas").diag
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-10)


def _mixed_problem(seed=0):
    """tests/test_iterative.py:15-27 with with_lp=False: blocks of 6, 6 and
    12, n = 12 (stacked by both packages as one group of three 16 x 16
    blocks)."""
    rng = np.random.default_rng(seed)
    n = 12
    As, Cs = [], []
    for m in (6, 6, 12):
        A = rng.standard_normal((n, m, m))
        As.append((A + A.transpose(0, 2, 1)) / 2)
        C = rng.standard_normal((m, m))
        Cs.append(C @ C.T + m * np.eye(m))
    return As, Cs, rng.standard_normal(n)


@pytest.mark.parametrize("prec", [0, 1, 2, 4])
def test_preconditioner_kinds_match_jax(prec, capsys):
    # every kind through the CG path (4 covers the hybrid beta -> alpha
    # switch), against JAX's run of the same problem (options of
    # tests/test_iterative.py:38-44): equal status, objective within 1e-6
    As, Cs, b = _mixed_problem()
    opts = {"kit": 1, "preconditioner": prec, "eDIMACS": 1e-5, "tol_cg_min": 1e-7,
            "erank": 1, "verb": 0}
    pj = lt.problem_from_dense(As, Cs, b)
    rj = lt.solve(pj, dict(opts, **JAX_MODES))
    pt = ltt.problem_from_dense(As, Cs, b, device="cpu")
    assert [(g.m, g.nb) for g in pt.groups] == [(g.m, g.nb) for g in pj.groups] == [(16, 3)]
    rt = ltt.solve(pt, dict(opts, verb=1), device="cpu")
    out = capsys.readouterr().out
    assert ("Switching to preconditioner 1" in out) == (prec == 4)
    assert f"Total CG iterations: {rt.cg_iterations:8d}" in out
    assert rt.status == rj.status == 1
    assert abs(rt.objective - rj.objective) <= 1e-6 * abs(rj.objective)
    assert rt.cg_iterations > 0 and len(rt.history) == rt.iterations
