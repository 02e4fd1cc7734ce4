"""ADMM (`ipm/admm.py`) of loraine_tpu_torch against the JAX package, on the
CPU, both with eigh_backend='xla' (the library's f64 eigh for the PSD
projection; the port's 'auto' takes the same route, and the eager f64
Jacobi would be far too slow for thousands of iterations): the same status,
iteration counts within 1%, objectives within 1e-7 relative. Then the IPM
warm-started from the ADMM iterate as in tests/test_admm.py: both packages
under EXACT_MODES reach the same status and iteration count, objectives
within 1e-8 relative.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from loraine_tpu.ipm.admm import solve_admm as jax_admm
from torch_cases import EXACT_MODES, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

THETA1 = str(pathlib.Path(__file__).parent / "data" / "theta1.dat-s")


def _same_admm(rj, rt):
    assert rt.status == rj.status == 1
    assert abs(rt.iterations - rj.iterations) <= 0.01 * rj.iterations
    assert abs(rt.objective - rj.objective) <= 1e-7 * max(abs(rj.objective), 1.0)


def test_admm_theta1_matches_jax():
    kw = dict(eps=1e-5, maxiter=20000, verb=0, chunk=1000, eigh_backend="xla")
    rj = jax_admm(lt.problem_from_sdpa(THETA1), **kw)
    rt = ltt.solve_admm(ltt.problem_from_sdpa(THETA1, device="cpu"), **kw)
    _same_admm(rj, rt)
    np.testing.assert_allclose(rt.objective, 23.0, rtol=1e-4)
    assert rt.X[0].shape == (50, 50)
    assert np.linalg.eigvalsh(rt.S[0]).min() > -1e-9


@pytest.mark.parametrize("chunk", [1, 7])
def test_admm_chunk_freezes_carry(chunk):
    # the host reads err once a chunk; the iterations queued after the
    # converging one leave the carry frozen, so the result and the count do
    # not depend on the chunk
    p = ltt.problem_from_sdpa(THETA1, device="cpu")
    kw = dict(eps=1e-3, maxiter=5000, verb=0, eigh_backend="xla")
    ref = ltt.solve_admm(p, chunk=1000, **kw)
    r = ltt.solve_admm(p, chunk=chunk, **kw)
    assert r.status == ref.status == 1
    assert r.iterations == ref.iterations
    assert r.err == ref.err
    np.testing.assert_array_equal(r.y, ref.y)
    np.testing.assert_array_equal(r.X[0], ref.X[0])
    # maxiter is checked at a chunk's end only, as in the JAX package
    cut = ltt.solve_admm(p, eps=1e-12, maxiter=10, verb=0, chunk=chunk, eigh_backend="xla")
    assert cut.status == 4
    assert cut.iterations == -(-10 // chunk) * chunk


def test_admm_lp_cone_matches_jax():
    # tests/test_admm.py::test_admm_with_lp_cone's problem
    rng = np.random.default_rng(3)
    n = 8
    A = rng.standard_normal((n, 6, 6))
    A = (A + A.transpose(0, 2, 1)) / 2
    C = rng.standard_normal((6, 6))
    C = C @ C.T + 6 * np.eye(6)
    C_lin = rng.standard_normal((n, 4))
    d_lin = np.abs(rng.standard_normal(4)) + 1.0
    b = rng.standard_normal(n)
    kw = dict(eps=1e-7, maxiter=50000, verb=0, chunk=2000, eigh_backend="xla")
    rj = jax_admm(lt.problem_from_dense([A], [C], b, C_lin=C_lin, d_lin=d_lin), **kw)
    pt = ltt.problem_from_dense([A], [C], b, C_lin=C_lin, d_lin=d_lin, device="cpu")
    rt = ltt.solve_admm(pt, **kw)
    _same_admm(rj, rt)
    np.testing.assert_allclose(rt.X_lin, rj.X_lin, atol=1e-6)
    ipm = ltt.solve(pt, {"verb": 0, "eDIMACS": 1e-8}, device="cpu")
    np.testing.assert_allclose(rt.objective, ipm.objective, rtol=1e-4, atol=1e-5)


def _warm_blocks(prob, blocks, tail):
    """tests/test_admm.py's warm start: the ADMM blocks padded to the group
    size, ``tail`` on the padding's diagonal, then + 1e-2 I."""
    out = []
    for g in prob.groups:
        mats = []
        for i in g.orig_indices:
            m0 = blocks[i].shape[0]
            M = np.pad(blocks[i], ((0, g.m - m0),) * 2)
            M = M + np.diag(np.r_[np.zeros(m0), np.ones(g.m - m0)] * tail)
            mats.append(M + 1e-2 * np.eye(g.m))
        out.append(np.stack(mats))
    return out


def test_admm_warm_starts_ipm_as_jax():
    kw = dict(eps=1e-3, maxiter=5000, verb=0, chunk=1000, eigh_backend="xla")
    pj = lt.problem_from_sdpa(THETA1)
    pt = ltt.problem_from_sdpa(THETA1, device="cpu")
    aj, at = jax_admm(pj, **kw), ltt.solve_admm(pt, **kw)
    _same_admm(aj, at)
    opts = {"eDIMACS": 1e-6, "verb": 0, **EXACT_MODES}
    sj = lt.IPMState(X=tuple(jnp.asarray(x) for x in _warm_blocks(pj, aj.X, 0.1)),
                     S=tuple(jnp.asarray(s) for s in _warm_blocks(pj, aj.S, 1.0)),
                     y=jnp.asarray(aj.y), X_lin=None, S_lin=None, sigma=jnp.asarray(3.0))
    st = ltt.IPMState(X=tuple(torch.from_numpy(x) for x in _warm_blocks(pt, at.X, 0.1)),
                      S=tuple(torch.from_numpy(s) for s in _warm_blocks(pt, at.S, 1.0)),
                      y=torch.from_numpy(at.y), X_lin=None, S_lin=None,
                      sigma=torch.tensor(3.0, dtype=torch.float64))
    rj = lt.Solver(pj, lt.Options.from_dict(opts), initial_state=sj).solve()
    rt = ltt.Solver(pt, opts, initial_state=st, device="cpu").solve()
    assert rt.status == rj.status == 1
    assert rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= 1e-8 * abs(rj.objective)
    # and under the port's own 'auto' (B1 and B2's plain versions here)
    ra = ltt.Solver(pt, {"eDIMACS": 1e-6, "verb": 0}, initial_state=st, device="cpu").solve()
    assert ra.status == 1
    np.testing.assert_allclose(ra.objective, 23.0, rtol=1e-6)
