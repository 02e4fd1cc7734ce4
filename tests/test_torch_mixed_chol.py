"""tests/test_mixed_chol.py on loraine_tpu_torch (`ops/mixed_chol.py`,
chol_backend='mixed'), case for case, and the port against the JAX
package's `chol_mixed_blocked` on the same inputs.

The two f32 seeds come from different LAPACKs (torch's, XLA's), so the
factors agree to what separates any two backward-stable Cholesky factors,
not bit for bit: forward error ~u sqrt(cond) (measured at n = 333:
6.6e-16, 1.2e-13, 1.4e-11, 1.3e-9 relative for cond 1e2, 1e6, 1e10, 1e14,
each as far from LAPACK's f64 factor as from the other package's). The
per-panel fallback decisions agree panel for panel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loraine_tpu.ops.mixed_chol import chol_mixed_blocked as jchol_mixed_blocked
from loraine_tpu.ops.mixed_chol import panel_chol_mixed as jpanel_chol_mixed
from loraine_tpu_torch.config import Options
from loraine_tpu_torch.ops import mixed_chol as tm
from loraine_tpu_torch.ops.linalg import chol_reg
from loraine_tpu_torch.ops.mixed_chol import chol_mixed_blocked, panel_chol_mixed
from torch_cases import sized_problem

U = 2.0**-53


def _spd(n, cond, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.logspace(0, -np.log10(cond), n)
    return torch.from_numpy(Q @ np.diag(lam) @ Q.T)


@pytest.mark.parametrize("n", [64, 128, 200, 333])
@pytest.mark.parametrize("cond", [1e2, 1e6, 1e10, 1e14])
def test_mixed_chol_matches_f64(n, cond):
    M = _spd(n, cond, seed=n)
    L = chol_mixed_blocked(M)
    assert not bool(torch.isnan(L).any())
    resid = torch.linalg.norm(M - L @ L.T) / torch.linalg.norm(M)
    # f64-class backward error at every conditioning (the per-panel
    # fallback covers what the f32 seed + Newton refinement cannot)
    assert float(resid) < 1e-13, (n, cond, float(resid))
    assert float(torch.triu(L, 1).abs().max()) == 0.0


def test_mixed_chol_batched():
    Ms = torch.stack([_spd(96, 1e4, seed=i) for i in range(3)])
    L = chol_mixed_blocked(Ms)
    resid = torch.linalg.norm(Ms - L @ L.mT) / torch.linalg.norm(Ms)
    assert float(resid) < 1e-13


def test_mixed_chol_indefinite_nan():
    M = _spd(128, 1e3, seed=7)
    M = M - 2.0 * float(torch.linalg.matrix_norm(M, 2)) * torch.eye(128, dtype=M.dtype)
    assert bool(torch.isnan(chol_mixed_blocked(M)).any())


def test_mixed_chol_batched_nan_only_where_it_fails():
    # the f64 fallback runs for the whole batch, NaN only in the element
    # that is indefinite (the JAX package's `jnp.linalg.cholesky`)
    good = _spd(200, 1e3, seed=1)
    bad = good - 2.0 * float(torch.linalg.matrix_norm(good, 2)) * torch.eye(200, dtype=good.dtype)
    L = chol_mixed_blocked(torch.stack([good, bad]))
    assert not bool(torch.isnan(L[0]).any()) and bool(torch.isnan(L[1]).any())
    assert float(torch.linalg.norm(good - L[0] @ L[0].T) / torch.linalg.norm(good)) < 1e-13


def test_chol_reg_mixed_backend_shift_semantics():
    # indefinite input must be shifted the same number of times as the f64
    # backend (NaN-keyed retry loop unchanged)
    M = _spd(160, 1e6, seed=3) - 1.5e-4 * torch.eye(160, dtype=torch.float64)
    r64 = chol_reg(M, 1e-4, 10, backend="f64")
    rmx = chol_reg(M, 1e-4, 10, backend="mixed")
    assert r64.shifts == rmx.shifts > 0
    assert r64.ok and rmx.ok
    np.testing.assert_allclose(rmx.L.numpy(), r64.L.numpy(), atol=1e-10)


def test_panel_inverse_accuracy():
    M = _spd(128, 1e8, seed=11)
    L, Li = panel_chol_mixed(M)
    err = torch.linalg.norm(Li @ L - torch.eye(128, dtype=torch.float64))
    assert float(err) < 1e-11


def test_auto_resolves_to_f64():
    # 'auto' is the f64 factorization on every device of the port (the JAX
    # package's off the TPU); explicit values stay
    for device in ("cpu", "cuda"):
        assert [Options(chol_backend=b).resolved(sized_problem(800), device).chol_backend
                for b in ("auto", "f64", "mixed")] == ["f64", "f64", "mixed"]


def test_counts_panels_and_syncs():
    before = dict(tm.STATS)
    chol_mixed_blocked(_spd(333, 1e2, seed=5))  # 3 panels, none falls back
    assert tm.STATS["panels"] - before["panels"] == 3
    assert tm.STATS["syncs"] - before["syncs"] == 6
    assert tm.STATS["fallbacks"] == before["fallbacks"]


@pytest.mark.parametrize("cond", [1e2, 1e6, 1e10, 1e14])
def test_matches_jax_mixed_chol(cond):
    """`chol_mixed_blocked` against the JAX function on the same input,
    within 8 u sqrt(cond) relative (see the module docstring), and the
    fallback taken on the same panels: each panel D of the port's
    elimination through both packages' `panel_chol_mixed` (the JAX panel
    fell back iff its L is `jnp.linalg.cholesky(D)` bit for bit)."""
    n = 333
    M = _spd(n, cond, seed=n)
    Lt = chol_mixed_blocked(M).numpy()
    Lj = np.asarray(jchol_mixed_blocked(jnp.asarray(M.numpy())))
    assert np.linalg.norm(Lt - Lj) <= 8 * U * np.sqrt(cond) * np.linalg.norm(Lj)
    T, k, decisions = M, 0, []
    while k < n:
        b = min(128, n - k)
        D = T[:b, :b]
        f0 = tm.STATS["fallbacks"]
        _, Ldi = panel_chol_mixed(D)
        Dj = jnp.asarray(D.numpy())
        jfell = np.array_equal(np.asarray(jpanel_chol_mixed(Dj)[0]),
                               np.asarray(jnp.linalg.cholesky(Dj)))
        decisions.append((tm.STATS["fallbacks"] > f0, jfell))
        if k + b < n:
            Lr = T[b:, :b] @ Ldi.mT
            T = T[b:, b:] - Lr @ Lr.mT
        k += b
    assert all(a == b for a, b in decisions), decisions
    # measured: every panel falls back at cond 1e14 (the f32 seed fails),
    # none below
    assert [a for a, _ in decisions] == [cond > 1e12] * 3
