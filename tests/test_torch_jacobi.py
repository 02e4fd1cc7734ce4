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


# --------------------------------------------------------------------------
# the CUDA kernel's regimes and its data movement, modelled in numpy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nb,mp,b1,b2", [
    (1, 16, "sm", "sm"), (1, 64, "sm", "sm"), (1, 112, "sm", "sm"), (1, 128, "sm", "sm"),
    (1, 144, "cluster", "sm"), (1, 160, "cluster", "sm"),  # shipped: tru3 .. tru9/vib9
    (3, 160, "cluster", "sm"), (4, 144, "sm", "sm"),       # one wave of clusters, two
    (1, 176, "cluster", "sm"), (1, 192, "cluster", "cluster"), (1, 224, "cluster", "cluster"),
    (7, 224, "cluster", "sm"), (1, 240, "cluster", "cluster"),
    (1, 800, "cluster", "cluster"), (2, 800, "cluster", "cluster"),  # maxG11
    (1, 816, "cluster", "cluster"),                                  # thetaG11
    (1, 912, "cluster", "cluster"), (1, 928, "rounds", "rounds"), (1, 1008, "rounds", "rounds"),
])
def test_regime_by_shape(nb, mp, b1, b2):
    for eigvecs, want in ((True, b1), (False, b2)):
        got = tj.regime_for(nb, mp, eigvecs)
        assert got == want
        assert tj.smem_bytes(got, mp, eigvecs) <= tj.SMEM_LIMIT
        fits = {r: tj.smem_bytes(r, mp, eigvecs) <= tj.SMEM_LIMIT for r in ("sm", "cluster")}
        if got == "rounds":  # only past both one-launch regimes
            assert not any(fits.values())
        if got == "cluster" and fits["sm"]:  # the faster, and all in one wave
            assert mp >= tj.CLUSTER_FROM[eigvecs]
            assert nb * (2 if eigvecs else 1) <= tj.CLUSTER_WAVE
        if got == "sm":  # the slower one, or more matrices than a wave holds
            assert mp < tj.CLUSTER_FROM[eigvecs] or nb * (1 + eigvecs) > tj.CLUSTER_WAVE


def _label_src(i, half, mp):
    """csrc/jacobi.cu::label_src."""
    if i == 0:
        return 0
    if i == 1:
        return half
    if i < half:
        return i - 1
    if i < mp - 1:
        return i + 1
    return half - 1


@pytest.mark.parametrize("mp", [16, 64, 160, 800, 816])
def test_label_recurrence_is_pair_table(mp):
    # the kernel's in-shared-memory labels: start at the identity, advance
    # by label_src after every round
    half = mp // 2
    src = np.array([_label_src(i, half, mp) for i in range(mp)])
    table = tj.pair_table(mp)
    lab = np.arange(mp)
    for r in range(2 * (mp - 1)):  # two sweeps: the table repeats
        np.testing.assert_array_equal(lab[:half], table[r % (mp - 1), 0])
        np.testing.assert_array_equal(lab[half:], table[r % (mp - 1), 1])
        lab = lab[src]
    np.testing.assert_array_equal(lab, np.arange(mp))


def _next_slots(sl, b, K):
    """csrc/jacobi.cu::cluster_kernel's slot table after the row move of
    block b (K local pairs): local positions 0..2K-1, then the two free."""
    f0, f1 = sl[2 * K], sl[2 * K + 1]
    last = tj.CLUSTER - 1
    new = []
    for l in range(2 * K + 2):
        if l < K:
            if b == 0:
                v = sl[0] if l == 0 else sl[K] if l == 1 else sl[l - 1]
            else:
                v = f0 if l == 0 else sl[l - 1]
        elif l < 2 * K - 1:
            v = sl[l + 1]
        elif l == 2 * K - 1:
            v = sl[K - 1] if b == last else f1
        elif l == 2 * K:
            v = f0 if b == 0 else f1 if b == last else sl[K - 1]
        else:
            v = sl[K - 1] if b == 0 else sl[K]
        new.append(v)
    return new


class _ClusterModel:
    """The rows of one matrix in a cluster: block b holds the rows of its
    top and bottom pair positions in row slots, through a slot table, and
    each round pulls one row from each neighbour into its free slots."""

    def __init__(self, M):
        self.mp = mp = M.shape[0]
        self.half = half = mp // 2
        self.split = tj.cluster_pairs(mp)
        self.K = [hi - lo for lo, hi in self.split]
        nslots = 2 * -(-half // tj.CLUSTER) + 2
        self.rows = [np.zeros((nslots, mp), M.dtype) for _ in self.split]
        self.sl = [list(range(2 * k + 2)) for k in self.K]
        for b, (lo, _) in enumerate(self.split):
            K = self.K[b]
            for l in range(2 * K):
                self.rows[b][l] = M[self.label0(b, l)]

    def label0(self, b, l):
        lo, K = self.split[b][0], self.K[b]
        return lo + l if l < K else self.half + lo + l - K

    def local(self, b):
        """(top rows, bottom rows) of block b, as slot indices."""
        K = self.K[b]
        return self.sl[b][:K], self.sl[b][K:2 * K]

    def move(self):
        last = tj.CLUSTER - 1
        for b, K in enumerate(self.K):
            f0, f1 = self.sl[b][2 * K], self.sl[b][2 * K + 1]
            # the free slots are not in use, the pulled rows are
            assert {f0, f1}.isdisjoint(self.sl[b][:2 * K])
            if b > 0:
                self.rows[b][f0] = self.rows[b - 1][self.sl[b - 1][self.K[b - 1] - 1]]
            if b < last:
                self.rows[b][f1] = self.rows[b + 1][self.sl[b + 1][self.K[b + 1]]]
        self.sl = [_next_slots(sl, b, K) for b, (sl, K) in enumerate(zip(self.sl, self.K))]
        for sl in self.sl:
            assert sorted(sl) == list(range(len(sl)))  # a permutation of the slots


@pytest.mark.parametrize("mp", [64, 160, 800, 816, 912])
def test_cluster_ownership_follows_pair_table(mp):
    half = mp // 2
    split = tj.cluster_pairs(mp)
    # a contiguous split of the pair positions; block 0 holds positions 0, 1
    assert split[0][0] == 0 and split[-1][1] == half
    assert all(a[1] == b[0] for a, b in zip(split, split[1:]))
    assert min(hi - lo for lo, hi in split) >= 2
    # the kernel's owner formula for the angle exchange
    for b, (lo, hi) in enumerate(split):
        for k in range(lo, hi):
            assert ((k + 1) * tj.CLUSTER - 1) // half == b
    # each row carries its label; after every move, block b holds exactly
    # the rows at its positions in pair_table's next round
    M = np.arange(mp, dtype=np.float64)[:, None] * np.ones(mp)
    model = _ClusterModel(M)
    table = tj.pair_table(mp)
    rounds = mp - 1 if mp <= 160 else 40
    for r in range(rounds + 1):
        for b, (lo, hi) in enumerate(split):
            top, bot = model.local(b)
            np.testing.assert_array_equal(model.rows[b][top, 0], table[r % (mp - 1), 0, lo:hi])
            np.testing.assert_array_equal(model.rows[b][bot, 0], table[r % (mp - 1), 1, lo:hi])
        model.move()
