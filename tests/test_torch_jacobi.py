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
    (1, 16, "sm", "sm"), (1, 64, "dsmem", "dsmem"), (1, 112, "dsmem", "dsmem"),
    (1, 128, "dsmem", "dsmem"),
    (1, 144, "dsmem", "dsmem"), (1, 160, "dsmem", "dsmem"),  # shipped: tru3 .. tru9/vib9
    (3, 160, "dsmem", "dsmem"), (4, 144, "dsmem", "dsmem"),  # one wave of "dsmem" clusters
    (8, 144, "sm", "sm"), (8, 160, "sm", "sm"),              # past it: the sizes' old regimes
    (1, 176, "dsmem", "dsmem"), (1, 192, "dsmem", "dsmem"), (1, 224, "dsmem", "dsmem"),
    (7, 224, "dsmem", "dsmem"), (8, 224, "cluster", "sm"), (1, 240, "dsmem", "dsmem"),
    (1, 288, "dsmem", "dsmem"), (1, 304, "cluster", "dsmem"),        # DSMEM_TO_FEW, B1
    (3, 304, "cluster", "dsmem"), (4, 304, "dsmem", "dsmem"),        # CLUSTER_PAIRS
    (1, 400, "cluster", "dsmem"), (1, 416, "cluster", "dsmem"), (1, 448, "cluster", "dsmem"),
    (1, 464, "cluster", "cluster"), (1, 480, "cluster", "cluster"),  # DSMEM_TO, B2
    (7, 464, "dsmem", "cluster"), (7, 480, "cluster", "cluster"),    # DSMEM_TO, B1
    (1, 496, "cluster", "cluster"),
    (1, 800, "cluster", "cluster"), (2, 800, "cluster", "cluster"),  # maxG11
    (1, 816, "cluster", "cluster"),                                  # thetaG11
    (1, 832, "cluster", "cluster"), (1, 848, "cluster", "grid"),     # CLUSTER_TO_ONE
    (2, 848, "cluster", "cluster"),
    (1, 912, "cluster", "grid"), (1, 928, "grid", "grid"), (1, 1008, "grid", "grid"),
    (2, 1008, "grid", "grid"), (1, 2000, "grid", "grid"),            # the tori
    (1, 2400, "grid", "grid"), (1, 2416, "rounds", "rounds"),        # GRID_MAX and past it
])
def test_regime_by_shape(nb, mp, b1, b2):
    for eigvecs, want in ((True, b1), (False, b2)):
        got = tj.regime_for(nb, mp, eigvecs)
        assert got == want
        assert tj.smem_bytes(got, mp, eigvecs, nb) <= tj.SMEM_LIMIT
        # "dsmem" exactly where the card timed it the fastest
        to = tj.DSMEM_TO_FEW if eigvecs and nb <= tj.CLUSTER_PAIRS else tj.DSMEM_TO[eigvecs]
        dsmem = nb <= tj.DSMEM_WAVE and mp <= to and tj._dsmem_fits(mp, eigvecs)
        assert (got == "dsmem") == dsmem
        fits = {r: tj.smem_bytes(r, mp, eigvecs) <= tj.SMEM_LIMIT for r in ("sm", "cluster")}
        fits["grid"] = tj.grid_plan(nb, mp, eigvecs)["fits"]
        if got == "rounds":  # only past every one-launch regime
            assert not any(fits.values())
        if got == "grid":  # past a cluster's capacity, or B2 of one matrix past mp 832
            b2_one = not eigvecs and nb == 1 and mp > tj.CLUSTER_TO_ONE
            assert not fits["sm"] and (not fits["cluster"] or b2_one)
        if got == "cluster":  # only where one block does not hold the matrix
            assert not fits["sm"]
        if got == "sm":  # below "dsmem"'s least size, or past one wave of it
            assert mp < 64 or nb > tj.DSMEM_WAVE


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


def _next_slots(sl, b, K, nblk=tj.CLUSTER):
    """csrc/jacobi.cu::next_slot: the slot table of block b of nblk (K local
    pairs) after the row move: local positions 0..2K-1, then the two free."""
    f0, f1 = sl[2 * K], sl[2 * K + 1]
    last = nblk - 1
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


def _slot_src(l, b, K, nblk):
    """csrc/jacobi.cu::slot_src: the index into the slot table that local
    position l's slot comes from in a round's move (2K, 2K+1: the free
    slots)."""
    if l < K:
        if b == 0:
            return 0 if l == 0 else K if l == 1 else l - 1
        return 2 * K if l == 0 else l - 1
    if l < 2 * K - 1:
        return l + 1
    if l == 2 * K - 1:
        return K - 1 if b == nblk - 1 else 2 * K + 1
    if l == 2 * K:
        return 2 * K if b == 0 else 2 * K + 1 if b == nblk - 1 else K - 1
    return K - 1 if b == 0 else K


@pytest.mark.parametrize("nblk", [4, 16])
def test_slot_src_is_next_slot(nblk):
    # the "dsmem" gather map (next table = table[slot_src]) is next_slot
    rng = np.random.default_rng(nblk)
    for K in (2, 3, 10):
        for b in range(nblk):
            sl = list(rng.permutation(2 * K + 2))
            assert [sl[_slot_src(l, b, K, nblk)] for l in range(2 * K + 2)] == \
                _next_slots(sl, b, K, nblk)


class _DsmemModel:
    """One matrix in the "dsmem" regime (csrc/jacobi.cu::dsmem): block b of
    nblk holds the rows of its pair positions (`grid_pairs`) in row slots,
    through its slot table, and keeps copies of its neighbours' tables; all
    three advance by the fixed gather map of `_slot_src`. After a round it
    stores its last top row into block b+1's free slot 2K and its first
    bottom row into block b-1's free slot 2K+1, as its copies of their
    tables name them. A row is its label."""

    def __init__(self, mp, nblk):
        self.half, self.nblk = mp // 2, nblk
        self.split = tj.grid_pairs(mp, nblk)
        self.K = [hi - lo for lo, hi in self.split]
        S = 2 * max(self.K) + 2
        self.rows = [np.full(S, -1) for _ in self.split]
        self.tab = [list(range(S)) for _ in self.split]              # own
        self.up = [list(range(S)) for _ in self.split]               # copy of b+1's
        self.dn = [list(range(S)) for _ in self.split]               # copy of b-1's
        for b, (lo, _) in enumerate(self.split):
            K = self.K[b]
            for l in range(2 * K):
                self.rows[b][l] = lo + l if l < K else self.half + lo + l - K

    def live(self, b):
        return set(self.tab[b][:2 * self.K[b]])

    def step(self):
        last = self.nblk - 1
        # the neighbours' copies agree with their own tables
        for b in range(self.nblk):
            if b < last:
                assert self.up[b][:2 * self.K[b + 1] + 2] == self.tab[b + 1][:2 * self.K[b + 1] + 2]
            if b > 0:
                assert self.dn[b][:2 * self.K[b - 1] + 2] == self.tab[b - 1][:2 * self.K[b - 1] + 2]
        # the pushes: every store lands in a slot no live position uses
        sent = []
        for b, K in enumerate(self.K):
            if b < last:
                dst = self.up[b][2 * self.K[b + 1]]
                assert dst not in self.live(b + 1)
                sent.append((b + 1, dst, self.rows[b][self.tab[b][K - 1]]))
            if b > 0:
                dst = self.dn[b][2 * self.K[b - 1] + 1]
                assert dst not in self.live(b - 1)
                sent.append((b - 1, dst, self.rows[b][self.tab[b][K]]))
        for b, dst, row in sent:
            self.rows[b][dst] = row

        def gather(t, blk, K):
            if not 0 <= blk <= last:
                return t
            return [t[_slot_src(l, blk, K, self.nblk)] if l < 2 * K + 2 else t[l]
                    for l in range(len(t))]
        K = self.K
        self.tab = [gather(t, b, K[b]) for b, t in enumerate(self.tab)]
        self.up = [gather(t, b + 1, K[b + 1] if b < last else 0) for b, t in enumerate(self.up)]
        self.dn = [gather(t, b - 1, K[b - 1] if b > 0 else 0) for b, t in enumerate(self.dn)]
        for b in range(self.nblk):
            assert sorted(self.tab[b]) == list(range(len(self.tab[b])))  # a permutation


@pytest.mark.parametrize("mp,nblk", [(16, 4), (64, 16), (160, 16), (160, 8), (224, 16)])
def test_dsmem_rows_follow_pair_table(mp, nblk):
    """The "dsmem" regime's row ownership and neighbour exchange at tru3's,
    theta1's, tru9's and a larger padded size: each position owned once,
    both rows of every pair in one block in every round of a sweep and the
    first of the next, each arriving row in a free slot. The kernel's
    clusters have 16 blocks; the layout's rules hold at any size, so mp 16,
    which a cluster of 16 cannot split, is modelled over 4, and mp 160 over
    8 as well."""
    half = mp // 2
    if mp < 64:  # a cluster of 16 needs two pairs a block
        assert not tj._dsmem_fits(mp, False) and tj.regime_for(1, mp, False) == "sm"
    else:
        assert tj.regime_for(1, mp, True) == tj.regime_for(1, mp, False) == "dsmem"
    split = tj.grid_pairs(mp, nblk)
    owned = np.concatenate([np.r_[lo:hi, half + lo:half + hi] for lo, hi in split])
    np.testing.assert_array_equal(np.sort(owned), np.arange(mp))
    assert min(hi - lo for lo, hi in split) >= 2 and max(hi - lo for lo, hi in split) <= 32
    model = _DsmemModel(mp, nblk)
    table = tj.pair_table(mp)
    src = np.array([_label_src(i, half, mp) for i in range(mp)])
    lab = np.arange(mp)  # the kernel's labels by position, gathered through label_src
    for r in range(mp):
        np.testing.assert_array_equal(lab[:half], table[r % (mp - 1), 0])
        np.testing.assert_array_equal(lab[half:], table[r % (mp - 1), 1])
        for b, (lo, hi) in enumerate(split):
            K = hi - lo
            sl = model.tab[b]
            np.testing.assert_array_equal(model.rows[b][sl[:K]], lab[lo:hi])
            np.testing.assert_array_equal(model.rows[b][sl[K:2 * K]], lab[half + lo:half + hi])
        model.step()
        lab = lab[src]


def _cyc(x, half):
    """csrc/jacobi.cu::wide::cyc: position x's place on the tournament's
    cycle (-1 for position 0, which keeps label 0)."""
    return -1 if x == 0 else x - 1 if x < half else 3 * half - 2 - x


def _label_of(c, rm, half):
    """csrc/jacobi.cu::wide::label_of: the label at place c after rm rounds."""
    if c < 0:
        return 0
    d = c - rm
    if d < 0:
        d += 2 * half - 1
    return d + 1 if d < half - 1 else 3 * half - 2 - d


@pytest.mark.parametrize("mp", [16, 64, 160, 496, 800, 816, 912])
def test_closed_form_labels_are_pair_table(mp):
    # the labels a "cluster" thread computes from a position's
    # place and the round modulo mp - 1, over two sweeps
    half = mp // 2
    table = tj.pair_table(mp)
    places = [_cyc(x, half) for x in range(mp)]
    for r in range(2 * (mp - 1)):
        lab = [_label_of(c, r % (mp - 1), half) for c in places]
        np.testing.assert_array_equal(lab[:half], table[r % (mp - 1), 0])
        np.testing.assert_array_equal(lab[half:], table[r % (mp - 1), 1])


def _rot_order(n, K):
    """The pair of the n-th row record: the inverse of `_rot_pos`."""
    return 0 if n == 0 else K - 1 if n == 1 else 1 if n == 2 else K - 2 if n == 3 else n - 2


def _rot_pos(i, K):
    """csrc/jacobi.cu::wide::rot_pos: the record of pair i."""
    return 0 if i == 0 else 1 if i == K - 1 else 2 if i == 1 else 3 if i == K - 2 else i + 2


def _next_pair_of(k, half):
    """csrc/jacobi.cu::next_pair_of: (ip, iq, pt, qt) of the next round's pair k."""
    xp, xq = _label_src(k, half, 2 * half), _label_src(k + half, half, 2 * half)
    return (xp if xp < half else xp - half, xq if xq < half else xq - half, xp < half, xq < half)


def _barrier1(lo, hi, half, nth):
    """csrc/jacobi.cu::wide::cluster_kernel's barrier 1: (threads in it,
    its rotating warps), the warps (2.., after the two control warps) with a
    column pair in [lo-1, hi]."""
    nu = nth - 64
    R = nu // half if nu >= half else 1
    ja, jb = max(lo - 1, 0), min(hi, half - 1)
    ng = R if R >= 2 else 2 if half > nu else 1
    cnt, last, warps = 32, 0, set()
    for g in range(ng):
        gg = g if R >= 2 else ng - 1 - g
        a0 = gg * half + ja if R >= 2 else ja - gg * nu
        a1 = gg * half + jb if R >= 2 else jb - gg * nu
        a0, a1 = max(a0, 0), min(a1, nu - 1)
        if a0 > a1:
            continue
        w0, w1 = a0 // 32 + 2, a1 // 32 + 2
        start = max(w0, last + 1)
        if w1 >= start:
            cnt += 32 * (w1 - start + 1)
            last = w1
        warps |= set(range(w0, w1 + 1))
    return cnt, warps


class _RoundModel:
    """One matrix in the "cluster" round (csrc/jacobi.cu::wide), nblk
    blocks: block b holds the
    rows of its pair positions (`grid_pairs`) in row slots through its slot
    table, advanced by the fixed gather of `_slot_src`; its records list its
    pairs' slots in rot_order; each round it copies its last top row into
    block b+1's free slot and its first bottom row into block b-1's, at the
    slots their edge messages of the round before named (their identity
    tables' 2K and 2K+1 at round 0), and sends each neighbour edge values and
    its own next free slot. A row is its label, an edge value the (row,
    column) labels of the element it copies, and every label a thread uses
    comes from `_label_of`."""

    def __init__(self, mp, nblk):
        self.mp, self.half, self.nblk = mp, mp // 2, nblk
        half = self.half
        self.split = tj.grid_pairs(mp, nblk)
        self.K = [hi - lo for lo, hi in self.split]
        S = 2 * max(self.K) + 2
        self.rows = [np.full(S, -1) for _ in self.split]
        self.tab = [list(range(S)) for _ in self.split]
        self.rec = [[None] * K for K in self.K]
        self.edge = []
        for b, (lo, hi) in enumerate(self.split):
            K = self.K[b]
            for l in range(2 * K):
                self.rows[b][l] = lo + l if l < K else half + lo + l - K
            for i in range(K):
                self.rec[b][_rot_pos(i, K)] = (i, K + i)
            tp, bt = [lo - 1, half + lo - 1, lo + 1, half + lo + 1], [hi, half + hi]
            e = {i: (tp[0], tp[i]) for i in range(4)}  # round 0: label = position
            e.update({12 + i: (tp[1], tp[i]) for i in range(4)})
            e.update({16: (bt[0], bt[0]), 17: (bt[0], bt[1]), 8: (bt[1], bt[0]), 9: (bt[1], bt[1])})
            e[4] = 2 * self.K[b - 1] + 1 if b > 0 else None
            e[10] = 2 * self.K[b + 1] if b < nblk - 1 else None
            self.edge.append(e)

    def check(self, r, lab):
        """Round r against the labels by position `lab` of pair_table."""
        half, rm = self.half, r % (self.mp - 1)
        for b, (lo, hi) in enumerate(self.split):
            K, sl, rows = self.K[b], self.tab[b], self.rows[b]
            np.testing.assert_array_equal(rows[sl[:K]], lab[lo:hi])
            np.testing.assert_array_equal(rows[sl[K:2 * K]], lab[half + lo:half + hi])
            for n in range(K):  # the records name the slots of their pairs
                i = _rot_order(n, K)
                assert self.rec[b][n] == (sl[i], sl[K + i])
            # warp 0's 2x2 blocks: the next pair lo + l's rows and columns
            e = self.edge[b]
            for l in range(K):
                ip, iq, _, _ = _next_pair_of(lo + l, half)
                assert lo - 1 <= ip <= hi and lo - 1 <= iq <= hi  # barrier 1's columns
                cols_p = [_label_of(_cyc(x, half), rm, half) for x in (ip, ip + half)]
                cols_q = [_label_of(_cyc(x, half), rm, half) for x in (iq, iq + half)]
                want = {k: [(lab[x], lab[y]) for x in (k, k + half) for y in (k, k + half)]
                        for k in (ip, iq)}
                want["pq"] = [(lab[x], lab[y]) for x in (ip, ip + half) for y in (iq, iq + half)]
                e_top, e_bot = b > 0 and l == 0, b < self.nblk - 1 and l == K - 1
                li, lj = (iq if e_top else ip) - lo, (ip if e_bot else iq) - lo

                def local(i, cols):
                    return [(rows[sl[m]], c) for m in (i, K + i) for c in cols]
                if e_top:
                    assert [e[k] for k in (0, 1, 12, 13)] == want[ip]
                    assert [e[k] for k in (2, 3, 14, 15)] == want["pq"]
                else:
                    assert local(li, cols_p) == want[ip] and local(li, cols_q) == want["pq"]
                if e_bot:
                    assert [e[k] for k in (16, 17, 8, 9)] == want[iq]
                else:
                    assert local(lj, cols_q) == want[iq]

    def step(self, r):
        """The copies and messages of round r, then the next round's tables."""
        half, rn, last = self.half, (r + 1) % (self.mp - 1), self.nblk - 1

        def nxt(x):
            return _label_of(_cyc(x, half), rn, half)
        tn, rec, out = [], [], []
        for b, (lo, hi) in enumerate(self.split):
            K, sl = self.K[b], self.tab[b]
            t = [sl[_slot_src(u, b, K, self.nblk)] if u < 2 * K + 2 else sl[u]
                 for u in range(len(sl))]
            assert sorted(t) == list(range(len(t)))  # a permutation of the slots
            tn.append(t)
            # warp 0 writes the next round's records from this round's table
            rec.append([(sl[_slot_src(_rot_order(n, K), b, K, self.nblk)],
                         sl[_slot_src(K + _rot_order(n, K), b, K, self.nblk)]) for n in range(K)])
            rows = self.rows[b]
            up = {i: (rows[t[K - 1]], nxt((half if i & 1 else 0) + hi + (1 if i & 2 else -1)))
                  for i in range(4)}
            up[4] = t[2 * K + 1]
            dn = {8: (rows[t[K]], nxt(lo)), 9: (rows[t[K]], nxt(half + lo)), 10: t[2 * K]}
            kept = {12 + i: (rows[sl[K]], nxt((half if i & 1 else 0) + lo + (1 if i & 2 else -1)))
                    for i in range(4)}
            kept.update({16: (rows[sl[K - 1]], nxt(hi)), 17: (rows[sl[K - 1]], nxt(half + hi))})
            out.append((up, dn, kept))
        copies = []
        for b in range(self.nblk):
            K, sl, e = self.K[b], self.tab[b], self.edge[b]
            if b < last:  # the last top row into b+1's free slot, its next local 0
                assert e[10] not in self.tab[b + 1][:2 * self.K[b + 1]] and e[10] == tn[b + 1][0]
                copies.append((b + 1, e[10], self.rows[b][sl[K - 1]]))
            if b > 0:  # the first bottom row into b-1's, its next local 2K-1
                Kd = self.K[b - 1]
                assert e[4] not in self.tab[b - 1][:2 * Kd] and e[4] == tn[b - 1][2 * Kd - 1]
                copies.append((b - 1, e[4], self.rows[b][sl[K]]))
        for b, slot, row in copies:
            self.rows[b][slot] = row
        self.edge = []
        for b in range(self.nblk):
            e = dict(out[b][2])
            if b > 0:
                e.update(out[b - 1][0])
            if b < last:
                e.update(out[b + 1][1])
            self.edge.append(e)
        self.tab, self.rec = tn, rec


def _round_model_runs(mp, nblk, rounds):
    half = mp // 2
    split = tj.grid_pairs(mp, nblk)
    owned = np.concatenate([np.r_[lo:hi, half + lo:half + hi] for lo, hi in split])
    np.testing.assert_array_equal(np.sort(owned), np.arange(mp))
    assert min(hi - lo for lo, hi in split) >= 2 and max(hi - lo for lo, hi in split) <= 32
    model = _RoundModel(mp, nblk)
    table = tj.pair_table(mp)
    for r in range(rounds):
        model.check(r, np.concatenate(table[r % (mp - 1)]))
        model.step(r)


@pytest.mark.parametrize("mp", [496, 800, 816, 912])
def test_cluster_round_tables_follow_pair_table(mp):
    """The "cluster" round at the padded sizes it takes for one matrix, maxG11's and thetaG11's among
    them: the labels, the slots, the records, the rows each block copies to
    and receives from its neighbours, the edge values and warp 0's 2x2
    blocks over 60 rounds (every table above repeats; a sweep is mp - 1
    rounds: `test_closed_form_labels_are_pair_table` covers the labels over
    two); barrier 1 holds exactly the warps whose columns warp 0 reads; each
    block's angles sit in a 16-byte aligned run of whole 16-byte units."""
    # (B2 of one matrix at mp 912 takes "grid", B2 of two "cluster")
    assert tj.regime_for(1, mp, True) == tj.regime_for(2, mp, False) == "cluster"
    _round_model_runs(mp, tj.CLUSTER, 60)
    half, nu = mp // 2, 1024 - 64
    pairs = -(-half // tj.CLUSTER)
    stride = 2 * -(-pairs // 2)  # csrc/jacobi.cu::wide::ang_stride
    for b, (lo, hi) in enumerate(tj.grid_pairs(mp, tj.CLUSTER)):
        cnt, warps = _barrier1(lo, hi, half, 1024)
        R = nu // half
        cols = set(range(max(lo - 1, 0), min(hi, half - 1) + 1))
        want = {u // 32 + 2 for u in range(nu) if u // half < R and u % half in cols}
        assert warps == want and cnt == 32 * (1 + len(want))
        for k in range(lo, hi):  # aidx: block b's run, in pair order
            assert ((k + 1) * tj.CLUSTER - 1) // half == b
        assert 16 * -(-(hi - lo) // 2) <= 8 * stride and (8 * stride) % 16 == 0


@pytest.mark.parametrize("mp", [64, 224, 416, 496, 800, 816, 912, 928])
def test_cluster_smem_bytes_mirror(mp):
    """`smem_bytes("cluster", ...)` against the layout of csrc/jacobi.cu::wide
    written out: three mbarriers, the row slots, two sets of row records,
    three rounds of angles in runs of an even count a block, warp 0's lane
    table, the edge values in and out, two slot tables of 16-bit entries;
    B1 the larger of that and a consumer block (mp rows of its columns, two
    rounds of angles and labels). The last size a cluster holds is 912."""
    half = mp // 2
    pairs = -(-half // 16)
    slots, stride = 2 * pairs + 2, 2 * -(-pairs // 2)
    rows = (32 + 4 * slots * mp + 16 * 2 * pairs + 8 * 3 * 16 * stride + 16 * 32
            + 4 * 2 * (24 + 12) + 2 * 2 * slots)
    c16 = -(-mp // 16)
    consumer = 4 * mp * 2 * -(-c16 // 2) + 8 * 2 * half + 4 * 2 * half
    assert tj.smem_bytes("cluster", mp, False) == rows
    assert tj.smem_bytes("cluster", mp, True) == max(rows, consumer)
    assert (tj.smem_bytes("cluster", mp, True) <= tj.SMEM_LIMIT) == (mp <= 912)


class _GridModel:
    """The rows of one matrix in the "grid" regime: block b holds the rows
    of its pair positions (`grid_pairs`) in row slots through a slot table;
    after each round it publishes its last top row (to b+1) and its first
    bottom row (to b-1) to an exchange buffer of the round's parity, and at
    the start of the next round copies its neighbours' into the slots of
    local positions 0 and 2K-1 (csrc/jacobi.cu::grid_kernel). A row is its
    label."""

    def __init__(self, mp, blocks):
        self.half = half = mp // 2
        self.G = blocks
        self.split = tj.grid_pairs(mp, blocks)
        self.K = [hi - lo for lo, hi in self.split]
        nslots = 2 * max(self.K) + 2
        self.rows = [np.full(nslots, -1) for _ in self.split]
        self.sl = [list(range(2 * k + 2)) for k in self.K]
        for b, (lo, _) in enumerate(self.split):
            K = self.K[b]
            for l in range(2 * K):
                self.rows[b][l] = lo + l if l < K else half + lo + l - K
        self.buf = {}

    def local(self, b):
        K = self.K[b]
        return self.sl[b][:K], self.sl[b][K:2 * K]

    def publish(self, par):
        for b, K in enumerate(self.K):
            if b < self.G - 1:
                self.buf[b, par, 0] = self.rows[b][self.sl[b][K - 1]]
            if b > 0:
                self.buf[b, par, 1] = self.rows[b][self.sl[b][K]]
        self.sl = [_next_slots(sl, b, K, self.G) for b, (sl, K) in enumerate(zip(self.sl, self.K))]
        for sl in self.sl:
            assert sorted(sl) == list(range(len(sl)))  # a permutation of the slots

    def arrive(self, par):
        for b, K in enumerate(self.K):
            sl, rows = self.sl[b], self.rows[b]
            if b > 0:
                rows[sl[0]] = self.buf.pop((b - 1, par, 0))
            if b < self.G - 1:
                rows[sl[2 * K - 1]] = self.buf.pop((b + 1, par, 1))
        assert not self.buf  # every published row arrived


@pytest.mark.parametrize("mp", [928, 1008, 2000])
def test_grid_rows_follow_pair_table(mp):
    """The grid regime's row partition at the padded sizes of maxG51 and the
    tori: each position owned once, both rows of every pair in one block's
    shared memory in every round of a sweep, each block within SMEM_LIMIT."""
    half = mp // 2
    for eigvecs in (True, False):
        plan = tj.grid_plan(1, mp, eigvecs)
        assert plan["fits"] and plan["per"] == 1 and plan["blocks"] == tj.H100_SMS
        assert tj.smem_bytes("grid", mp, eigvecs) <= tj.SMEM_LIMIT
        assert plan["vsmem"] == (eigvecs and mp < 2000)  # mp 2000: V in global memory
    split = tj.grid_pairs(mp, tj.H100_SMS)
    owned = np.concatenate([np.r_[lo:hi, half + lo:half + hi] for lo, hi in split])
    np.testing.assert_array_equal(np.sort(owned), np.arange(mp))  # each position once
    assert min(hi - lo for lo, hi in split) >= 2 and max(hi - lo for lo, hi in split) <= 32
    model = _GridModel(mp, tj.H100_SMS)
    table = tj.pair_table(mp)
    for r in range(mp):  # a sweep and the first round of the next
        if r > 0:
            model.arrive(r & 1)
        held = [[model.rows[b][s] for s in model.local(b)] for b in range(len(split))]
        np.testing.assert_array_equal(np.concatenate([t for t, _ in held]), table[r % (mp - 1), 0])
        np.testing.assert_array_equal(np.concatenate([u for _, u in held]), table[r % (mp - 1), 1])
        model.publish((r + 1) & 1)


@pytest.mark.parametrize("sms,last", [(132, 2400), (114, 2272), (78, 1920), (16, 928)])
def test_grid_capacity_follows_the_sm_count(sms, last):
    """On a card with fewer SMs (an H100 PCIe has 114, a MIG slice fewer)
    "grid" plans fewer blocks and ends sooner; past its last size the
    shape takes "rounds", and every plan it takes the card can hold."""
    for eigvecs in (True, False):
        fit = [mp for mp in range(928, 2432, 16) if tj.grid_plan(1, mp, eigvecs, sms)["fits"]]
        assert fit == list(range(928, last + 16, 16))
        assert tj.regime_for(1, last, eigvecs, sms) == "grid"
        assert tj.regime_for(1, last + 16, eigvecs, sms) == "rounds"
        for nb, mp in ((1, last), (3, 1008), (2, 928)):
            plan = tj.grid_plan(nb, mp, eigvecs, sms)
            if plan["fits"]:
                assert plan["per"] * plan["blocks"] <= sms
                assert tj.smem_bytes("grid", mp, eigvecs, nb, sms) <= tj.SMEM_LIMIT


@pytest.mark.parametrize("nb,mp", [(2, 1008), (3, 1008), (6, 1008), (2, 2000), (20, 928)])
def test_grid_plan_shares_the_card(nb, mp):
    """Several matrices share one launch while each keeps enough blocks for
    its rows (csrc/jacobi.cu::grid_plan); the rest run in further launches."""
    for eigvecs in (True, False):
        plan = tj.grid_plan(nb, mp, eigvecs)
        assert plan["fits"] and 1 <= plan["per"] <= nb
        assert plan["per"] * plan["blocks"] <= tj.H100_SMS
        assert tj.smem_bytes("grid", mp, eigvecs, nb) <= tj.SMEM_LIMIT
        if plan["per"] < nb:  # one more matrix at once would not fit
            more = tj.grid_plan(plan["per"] + 1, mp, eigvecs)
            assert more["per"] == plan["per"]
