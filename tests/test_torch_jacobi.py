"""loraine_tpu_torch/ops/jacobi.py against the Pallas kernels it replaces.

The plain PyTorch versions of B1 (eigenbasis seed) and B2 (spectral bounds)
run on the CPU against `eigh_pallas_f32` / `eig_bounds_pallas` of the JAX
package in Pallas interpret mode, on the same seeded numpy inputs. The CUDA
kernels themselves run only on a card: tests/test_torch_cuda.py and
chip_smoke.py hold them against the plain versions there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from loraine_tpu.ops import jacobi_pallas as jp
from loraine_tpu_torch.ops import jacobi as tj
from torch_cases import spectrum_matrix


CASES = [(m, kind) for m in (6, 16, 23, 56) for kind in ("random", "clustered", "graded")]


@pytest.mark.parametrize("mp", [16, 64, 800])
def test_pair_table_is_a_tournament(mp):
    t = tj.pair_table(mp)
    half = mp // 2
    assert t.shape == (mp - 1, 2, half)
    # round 0 pairs position i with i + mp/2 in the identity labelling
    np.testing.assert_array_equal(t[0, 0], np.arange(half))
    np.testing.assert_array_equal(t[0, 1], np.arange(half, mp))
    # every round is a perfect matching; every unordered pair once a sweep
    for r in range(mp - 1):
        np.testing.assert_array_equal(np.sort(t[r].ravel()), np.arange(mp))
    lo = np.minimum(t[:, 0], t[:, 1]).ravel().astype(np.int64)
    hi = np.maximum(t[:, 0], t[:, 1]).ravel().astype(np.int64)
    assert np.unique(lo * mp + hi).size == mp * (mp - 1) // 2


@pytest.mark.parametrize("mp", [16, 32, 64])
def test_pair_table_reproduces_pallas_permutation(mp):
    # After ONE sweep the matrix is far from diagonal, so the result depends
    # on the rotation order: another schedule (e.g. ops/eigh.round_robin_pairs)
    # lands >= 0.3 away on these inputs. The same order agrees to ~1e-4: f32
    # rounding differs (XLA vs eager torch) and near-degenerate pairs amplify
    # it into the angles. Hence 1e-3 on a unit-norm input.
    A = spectrum_matrix("random", mp, 2, seed=mp)
    Mn, _ = tj._normalize_pad(torch.from_numpy(A))
    lam_j, vt_j = jp._eigh_pallas_padded(jnp.asarray(Mn.numpy()), 1, True)
    lam_t, vt_t = tj.jacobi_eigh_plain(Mn, 1)
    off = Mn.numpy() - np.asarray(lam_j)[:, :, None] * np.eye(mp)
    assert np.abs(off).max() > 1e-3  # not converged: the order matters
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), atol=1e-3)
    np.testing.assert_allclose(vt_t.numpy(), np.asarray(vt_j), atol=1e-3)
    g_j, h_j = jp._eigmin_pallas_padded(jnp.asarray(Mn.numpy()), 1, True)
    g_t, h_t = tj.jacobi_bounds_plain(Mn, 1)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-3)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-3)


@pytest.mark.parametrize("m,kind", CASES)
def test_eigh_plain_matches_pallas(m, kind):
    A = spectrum_matrix(kind, m, 2, seed=7 * m + len(kind))
    lam_j, V_j = jp.eigh_pallas_f32(jnp.asarray(A), interpret=True)
    lam_t, V_t = tj.eigh_jacobi_f32(torch.from_numpy(A))
    lam_j = np.asarray(lam_j, np.float64)
    lam_t = lam_t.numpy().astype(np.float64)
    V = V_t.numpy().astype(np.float64)
    ev = np.linalg.eigvalsh(A)
    scale = np.abs(ev).max()
    # same rotations in the same order, f32 rounding apart: 1e-5 * scale
    assert np.abs(lam_t - lam_j).max() < 1e-5 * scale
    # seed quality against f64 (tests/test_jacobi_pallas.py contract)
    assert np.abs(lam_t - ev).max() < 5e-5 * scale
    R = (V * lam_t[:, None, :]) @ V.transpose(0, 2, 1)
    assert np.abs(R - A).max() < 1e-4 * scale
    assert np.abs(V.transpose(0, 2, 1) @ V - np.eye(m)).max() < 1e-4


@pytest.mark.parametrize("m,kind", CASES)
def test_bounds_plain_match_pallas_and_hold(m, kind):
    A = spectrum_matrix(kind, m, 3, seed=11 * m + len(kind))
    lo_j, hi_j = jp.eig_bounds_pallas(jnp.asarray(A), interpret=True)
    lo_t, hi_t = tj.eig_bounds_jacobi(torch.from_numpy(A))
    lo_t, hi_t = lo_t.numpy(), hi_t.numpy()
    scale = np.max(np.sum(np.abs(A), axis=-1), axis=-1)
    # Same rotations, f32 rounding apart. On clustered spectra the
    # near-degenerate pairs amplify that rounding into the residual
    # off-diagonal mass the Gershgorin bound adds: measured up to 7.1e-5 *
    # scale (m=56, clustered), of the order of each bound's own slack to
    # lambda (1e-5 .. 1.1e-4 * scale). Hence 1e-4 * scale, inside the 2e-4
    # tightness budget below.
    assert np.max(np.abs(lo_t - np.asarray(lo_j)) / scale) < 1e-4
    assert np.max(np.abs(hi_t - np.asarray(hi_j)) / scale) < 1e-4
    # certified: lo <= lambda_min, hi >= lambda_max (f64 eigenvalues)
    ev = np.linalg.eigvalsh(A)
    assert (lo_t <= ev[:, 0] + 1e-12).all()
    assert (hi_t >= ev[:, -1] - 1e-12).all()
    assert np.max((ev[:, 0] - lo_t) / scale) < 2e-4
    assert np.max((hi_t - ev[:, -1]) / scale) < 2e-4


def test_cpu_tensors_take_the_plain_version():
    A = torch.from_numpy(spectrum_matrix("random", 20, 1, seed=1))
    fns = (tj.jacobi_eigh_cuda, tj.jacobi_bounds_cuda)
    before = [sum(fn.launches_by_mp.values()) for fn in fns]
    tj.eigh_jacobi_f32(A)
    tj.eig_bounds_jacobi(A)
    assert [sum(fn.launches_by_mp.values()) for fn in fns] == before
    with pytest.raises(ValueError):
        tj.jacobi_eigh_padded(torch.zeros((1, 16, 16), device="meta"), 1)
