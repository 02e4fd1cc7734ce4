"""loraine_tpu_torch ops against the JAX package's, on the same inputs.

Inputs are seeded numpy arrays fed to both packages. The JAX side runs with
eigh_backend='pallas', i.e. the Pallas Jacobi kernel in interpret mode, the
port with its plain Jacobi versions on the CPU. Tolerance: 1e-10 relative
wherever an f32 Jacobi seed sits under the f64 refinement (the two seeds
differ at f32 rounding, the refinement removes it to ~1e-12 on
well-separated spectra), and 1e-12 for pure f64 contractions (summation
order only).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loraine_tpu as lt
from loraine_tpu.ops import eigh as jeigh, linalg as jlin, nt_scaling as jnt, schur as jschur
from loraine_tpu_torch.convert import problem_from_numpy
from loraine_tpu_torch.ops import eigh as teigh, linalg as tlin, nt_scaling as tnt, schur as tschur

DATA = pathlib.Path(__file__).parent / "data"


def spd(rng, nb, m, lo=-1.0, hi=1.0):
    """Symmetric positive definite [nb, m, m] with log-uniform spectrum in
    [10^lo, 10^hi]: well separated, so the f64 refinement resolves every
    eigenpair."""
    Q = np.linalg.qr(rng.standard_normal((nb, m, m)))[0]
    d = 10.0 ** rng.uniform(lo, hi, (nb, m))
    A = Q @ (d[:, :, None] * np.eye(m)) @ Q.transpose(0, 2, 1)
    return (A + A.transpose(0, 2, 1)) / 2


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def problems():
    """theta1 (dense) and a rank-1 max-cut, in both packages."""
    from torch_cases import maxcut_sdpa
    from loraine_tpu.io.sdpa import SDPAData as JaxSDPAData
    from loraine_tpu.problem import problem_from_sdpa

    dense = lt.load_problem(str(DATA / "theta1.dat-s"))
    rank1 = problem_from_sdpa(maxcut_sdpa(cls=JaxSDPAData), datarank=-1)
    return {
        name: (pj, problem_from_numpy(jax.device_get(pj), device="cpu"))
        for name, pj in (("dense", dense), ("rank1", rank1))
    }


@pytest.mark.parametrize("m", [23, 56])
def test_eigh_mixed_matches_jax(m):
    M = spd(np.random.default_rng(m), 2, m)
    lj, Vj = jeigh.eigh_mixed(jnp.asarray(M), seed="pallas")
    lt_, Vt = teigh.eigh_mixed(torch.from_numpy(M), seed="pallas")
    assert rel(lt_.numpy(), lj) < 1e-10
    # same Jacobi rotations give the same eigenvector signs
    assert rel(Vt.numpy(), Vj) < 1e-10
    R = (Vt * lt_[:, None, :]) @ Vt.mT
    assert rel(R.numpy(), M) < 1e-12


@pytest.mark.parametrize("m", [16, 56])
def test_nt_scale_matches_jax(m):
    rng = np.random.default_rng(100 + m)
    X, S = spd(rng, 2, m), spd(rng, 2, m)
    a = jnt.nt_scale(jnp.asarray(X), jnp.asarray(S), eigh_backend="pallas")
    b = tnt.nt_scale(torch.from_numpy(X), torch.from_numpy(S))
    for k in ("D", "G", "Gi", "W", "Si", "DDsi"):
        assert rel(getattr(b, k).numpy(), getattr(a, k)) < 1e-10, k
    assert bool(b.ok) and not b.shifted and not bool(b.s_indef)


@pytest.mark.parametrize("kind", ["dense", "rank1"])
def test_data_operators_match_jax(problems, kind):
    pj, pt = problems[kind]
    gj, gt = pj.groups[0], pt.groups[0]
    rng = np.random.default_rng(5)
    X = spd(rng, gj.nb, gj.m)
    y = rng.standard_normal(pj.n)
    assert rel(tschur.Aop(gt, torch.from_numpy(X)).numpy(), jschur.Aop(gj, jnp.asarray(X))) < 1e-12
    assert rel(tschur.Aadj(gt, torch.from_numpy(y)).numpy(), jschur.Aadj(gj, jnp.asarray(y))) < 1e-12


@pytest.mark.parametrize("kind", ["dense", "rank1"])
def test_schur_group_matches_jax(problems, kind):
    pj, pt = problems[kind]
    gj, gt = pj.groups[0], pt.groups[0]
    rng = np.random.default_rng(6)
    nt = jnt.nt_scale(jnp.asarray(spd(rng, gj.nb, gj.m)), jnp.asarray(spd(rng, gj.nb, gj.m)),
                      eigh_backend="pallas")
    W, G = np.array(nt.W), np.array(nt.G)
    Hj = jschur.schur_group(gj, jnp.asarray(W), jnp.asarray(G))
    Ht = tschur.schur_group(gt, torch.from_numpy(W), torch.from_numpy(G))
    assert rel(Ht.numpy(), Hj) < 1e-12


def test_schur_dense_chunked_matches_unchunked(problems):
    _, pt = problems["dense"]
    g = pt.groups[0]
    W = torch.from_numpy(spd(np.random.default_rng(8), g.nb, g.m))
    full = tschur.schur_group(g, W, W)
    chunked = tschur._dense_rows(g.A, g.A, W)
    assert rel(chunked.numpy(), full.numpy()) < 1e-12


def test_chol_reg_tri_inv_cho_solve_match_jax():
    rng = np.random.default_rng(9)
    n = 60
    A = rng.standard_normal((n, n))
    H = A @ A.T + n * np.eye(n)
    cj = jlin.chol_reg(jnp.asarray(H), 1e-4, 1000)
    ct = tlin.chol_reg(torch.from_numpy(H), 1e-4, 1000)
    assert ct.ok and ct.shifts == int(cj.shifts) == 0
    assert rel(ct.L.numpy(), cj.L) < 1e-12
    Lij = jlin.tri_inv(cj.L)
    Lit = tlin.tri_inv(ct.L)
    assert rel(Lit.numpy(), Lij) < 1e-12
    b = rng.standard_normal(n)
    xj = jlin.cho_solve_inv(Lij, jnp.asarray(b))
    xt = tlin.cho_solve_inv(Lit, torch.from_numpy(b))
    assert rel(xt.numpy(), xj) < 1e-12
    assert np.linalg.norm(H @ xt.numpy() - b) / np.linalg.norm(b) < 1e-12


def test_chol_reg_shifts_like_jax():
    # a batch with one PD and one indefinite element: only the failing one is
    # shifted, and both packages need the same number of 1e-2 shifts
    rng = np.random.default_rng(10)
    P = spd(rng, 1, 12)[0]
    N = P - 0.055 * np.eye(12) - np.min(np.linalg.eigvalsh(P)) * np.eye(12)
    M = np.stack([P, N])
    cj = jlin.chol_reg(jnp.asarray(M), 1e-2, 1000)
    ct = tlin.chol_reg(torch.from_numpy(M), 1e-2, 1000)
    assert ct.ok and bool(cj.ok)
    assert ct.shifts == int(cj.shifts) == 6
    assert rel(ct.L.numpy(), cj.L) < 1e-12
    bad = tlin.chol_reg(torch.from_numpy(M), 1e-2, 2)
    assert not bad.ok and torch.isnan(bad.L[1]).all() and not torch.isnan(bad.L[0]).any()
