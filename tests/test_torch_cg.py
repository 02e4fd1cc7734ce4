"""The CG modules of loraine_tpu_torch against the JAX package's, on the CPU.

`ops/cg.py` (`pcg`, `cg_plain`) against `loraine_tpu/ops/cg.py`, and the
plain versions of the two CG kernels inside their refinement wrappers
(`ops/pcg.py`: B3 `pcg_kernel_ff`, B4 `pcg_kernel_mixed`) against
`loraine_tpu/ops/pcg_pallas.py` in interpret mode, on seeded numpy systems
(the ones of tests/test_pcg_pallas.py). On a CPU tensor the wrappers run
the plain versions; the kernels themselves are held against these on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loraine_tpu.ops.cg import cg_plain as jax_cg_plain, pcg as jax_pcg
from loraine_tpu.ops.pcg_pallas import pcg_pallas_ff, pcg_pallas_mixed
from loraine_tpu_torch.ops import cg as tcg, pcg as tp


def _sys(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    H = (Q * np.logspace(0, -np.log10(cond), n)) @ Q.T
    return (H + H.T) / 2, rng.standard_normal(n)


def _precond_sys(n, seed):
    """kappa(H) = 1e8 with the inverse Cholesky factor of H + 1e-6 I as Mli
    (tests/test_pcg_pallas.py:44-55). b = H x_true: with a normal b,
    x ~ 1e8 |b| and the f64 residual itself is only good to ~1e-8."""
    H, x_true = _sys(n, 1e8, seed)
    L = np.linalg.cholesky(H + 1e-6 * np.eye(n))
    return H, H @ x_true, np.linalg.solve(L, np.eye(n))


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _res(H, b, x):
    return np.linalg.norm(b - H @ np.asarray(x)) / np.linalg.norm(b)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("which", ["pcg", "cg_plain"])
@pytest.mark.parametrize("cond", [1e1, 1e3])
@pytest.mark.parametrize("n", [21, 104])
def test_cg_matches_jax(n, cond, which):
    # same recurrences in f64, other summation order: iterations within 1,
    # x within 1e-10 relative (measured <= 2e-13 here)
    H, b = _sys(n, cond, seed=n)
    d = 1.0 + np.arange(n) / n  # a diagonal preconditioner for pcg
    tol = 1e-10
    Hj, bj, dj = jnp.asarray(H), jnp.asarray(b), jnp.asarray(d)
    Ht, bt, dt = _t(H), _t(b), _t(d)
    if which == "pcg":
        xj, ij = jax_pcg(lambda v: Hj @ v, bj, lambda v: v / dj, tol, 5000)
        xt, it = tcg.pcg(lambda v: Ht @ v, bt, lambda v: v / dt, tol, 5000)
    else:
        xj, ij = jax_cg_plain(lambda v: Hj @ v, bj, tol, 5000)
        xt, it = tcg.cg_plain(lambda v: Ht @ v, bt, tol, 5000)
    assert it.dtype == torch.int32 and it.ndim == 0
    assert abs(int(it) - int(ij)) <= 1
    assert _rel(xt, xj) <= 1e-10
    assert _res(H, b, xt) <= tol


@pytest.mark.parametrize("cond", [1e1, 1e3])
@pytest.mark.parametrize("n", [21, 104])
def test_b4_plain_matches_pallas_mixed(n, cond):
    # the f32 body in f64 refinement, identity preconditioner, at tol 1e-10
    # (tests/test_pcg_pallas.py:26-41): both meet the tolerance and land
    # within 1e-8 of each other (f32 bodies with other summation orders)
    H, b = _sys(n, cond, seed=n)
    xj, ij = pcg_pallas_mixed(jnp.asarray(H), jnp.eye(n), jnp.asarray(b), 1e-10, 5000)
    xt, it = tp.pcg_kernel_mixed(_t(H), torch.eye(n, dtype=torch.float64), _t(b), 1e-10, 5000)
    assert _res(H, b, xt) <= 1e-10 and _res(H, b, xj) <= 1e-10
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-8)
    assert int(it) > 0 and abs(int(it) - int(ij)) <= 0.1 * int(ij) + 2


@pytest.mark.parametrize("cond", [1e1, 1e3])
@pytest.mark.parametrize("n", [21, 104])
def test_b3_plain_matches_pallas_ff(n, cond):
    # interpret mode runs the ff body only f32-exact (pcg_pallas.py:237-247),
    # so the comparison is at its contract, tol 1e-6 (test_pcg_pallas.py:96-112)
    H, b = _sys(n, cond, seed=n)
    xj, _ = pcg_pallas_ff(jnp.asarray(H), jnp.eye(n), jnp.asarray(b), 1e-6, 5000)
    xt, it = tp.pcg_kernel_ff(_t(H), torch.eye(n, dtype=torch.float64), _t(b), 1e-6, 5000)
    assert _res(H, b, xt) <= 1e-6 and _res(H, b, xj) <= 1e-5
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4 * np.abs(xt.numpy()).max())
    assert int(it) > 0


@pytest.mark.parametrize("n", [21, 104])
def test_b3_plain_matches_jax_f64_pcg_preconditioned(n):
    # the f64 body at tol 1e-12 on the kappa = 1e8 system, preconditioned,
    # against JAX's f64 pcg. Two solutions with residuals below
    # tol differ by at most 2 kappa tol = 2e-4 relative; measured 4.3e-9
    H, b, Mli = _precond_sys(n, seed=n + 1)
    M = Mli.T @ Mli
    Hj, Mj = jnp.asarray(H), jnp.asarray(M)
    xj, _ = jax_pcg(lambda v: Hj @ v, jnp.asarray(b), lambda v: Mj @ v, 1e-12, 5000)
    xt, it = tp.pcg_kernel_ff(_t(H), _t(Mli), _t(b), 1e-12, 5000)
    assert _res(H, b, xt) <= 1e-12 and _res(H, b, xj) <= 1e-12
    assert _rel(xt, xj) <= 2 * 1e8 * 1e-12


@pytest.mark.parametrize("wrapper", [tp.pcg_kernel_ff, tp.pcg_kernel_mixed])
def test_converged_rhs_is_free(wrapper):
    # an already-converged pass exits before its first iteration
    H, b = _sys(32, 1e2, seed=5)
    x, its = wrapper(_t(H), torch.eye(32, dtype=torch.float64), _t(b) * 0.0, 1e-8, 100)
    assert int(its) == 0 and float(x.abs().max()) == 0.0


def test_b3_never_worsens():
    # (tests/test_pcg_pallas.py:115-125) kappa 1e8, identity preconditioner:
    # the returned x is no worse than x = 0 ...
    H, b = _sys(200, 1e8, seed=3)
    eye = torch.eye(200, dtype=torch.float64)
    x, _ = tp.pcg_kernel_ff(_t(H), eye, _t(b), 1e-6, 10000)
    assert _res(H, b, x) <= 1.0 + 1e-12 and bool(torch.isfinite(x).all())
    # ... and a pass that worsens the f64 residual is rejected outright
    def bad(Hp, rhs, tol2, maxiter, stall):
        return 1e6 * torch.ones_like(rhs), torch.tensor(7, dtype=torch.int32)

    x, its = tp.pcg_kernel_ff(_t(H), eye, _t(b), 1e-6, 10000, body=bad)
    assert float(x.abs().max()) == 0.0 and int(its) == 14


def test_b3_stall_exit_fires_before_cap():
    # tol2 = 0 cannot be met, and at kappa 1e14 the residual plateaus: the
    # stall counter (np/2 + 64 = 128 at n = 21) ends the loop long before
    # the cap, with the best iterate seen (no worse than x = 0)
    H, b = _sys(21, 1e14, seed=7)
    Hp, rhs = _t(H), _t(b) / np.linalg.norm(b)
    assert tp.stall_limit(21) == 128 and tp.stall_limit(464) == 320
    zero = torch.tensor(0.0, dtype=torch.float64)
    x, it = tp.cg_minres_plain(Hp, rhs, zero, 5000, 128)
    assert 128 < int(it) < 5000
    # without the stall exit the same loop runs to the cap
    x_cap, it_cap = tp.cg_minres_plain(Hp, rhs, zero, 5000, 10**9)
    assert int(it_cap) == 5000
    r_best = float(torch.linalg.norm(rhs - Hp @ x))
    assert r_best <= 1.0 and bool(torch.isfinite(x).all())
    assert float(torch.linalg.norm(rhs - Hp @ x_cap)) <= r_best


def test_cuda_routes_refuse_cpu_tensors():
    # the CUDA launchers check their inputs before anything is built
    H = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="cuda|float64"):
        tp.cg_minres_f64_cuda(H, torch.ones(4, dtype=torch.float64),
                              torch.tensor(0.0, dtype=torch.float64), 10, 10)
    with pytest.raises(ValueError, match="float32"):
        tp.cg_f32_cuda(H, torch.ones(4, dtype=torch.float64), torch.tensor(0.0), 10)
