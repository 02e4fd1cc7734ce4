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
    (1, 400, "dsmem", "dsmem"), (1, 416, "cluster", "dsmem"), (1, 480, "cluster", "dsmem"),
    (1, 496, "cluster", "cluster"),                                  # DSMEM_TO and past it
    (1, 800, "cluster", "cluster"), (2, 800, "cluster", "cluster"),  # maxG11
    (1, 816, "cluster", "cluster"),                                  # thetaG11
    (1, 912, "cluster", "cluster"), (1, 928, "grid", "grid"), (1, 1008, "grid", "grid"),
    (2, 1008, "grid", "grid"), (1, 2000, "grid", "grid"),            # the tori
    (1, 2400, "grid", "grid"), (1, 2416, "rounds", "rounds"),        # GRID_MAX and past it
])
def test_regime_by_shape(nb, mp, b1, b2):
    for eigvecs, want in ((True, b1), (False, b2)):
        got = tj.regime_for(nb, mp, eigvecs)
        assert got == want
        assert tj.smem_bytes(got, mp, eigvecs, nb) <= tj.SMEM_LIMIT
        # "dsmem" exactly where the card timed it the fastest
        dsmem = nb <= tj.DSMEM_WAVE and mp <= tj.DSMEM_TO[eigvecs] and tj._dsmem_fits(mp, eigvecs)
        assert (got == "dsmem") == dsmem
        fits = {r: tj.smem_bytes(r, mp, eigvecs) <= tj.SMEM_LIMIT for r in ("sm", "cluster")}
        fits["grid"] = tj.grid_plan(nb, mp, eigvecs)["fits"]
        if got == "rounds":  # only past every one-launch regime
            assert not any(fits.values())
        if got == "grid":  # only past a cluster's capacity
            assert not fits["sm"] and not fits["cluster"]
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
