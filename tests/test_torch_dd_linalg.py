"""loraine_tpu_torch.ops.dd_linalg against the mpmath oracles of
tests/test_dd_linalg.py and against the JAX package.

Every case of tests/test_dd_linalg.py runs here with the same tolerances,
the native dd NT scaling (`ops/nt_scaling.py:nt_scale_dd`) included. The
JAX test's alias check guards against XLA:CPU's simplifier; the port runs
eagerly, so the same computation is held to the same oracle without jit.
On the CPU the matrix functions run the plain versions of the kernels
D1-D3 (`csrc/dd_linalg.cu`). On the same inputs `dd_chol`, `dd_matmul` and
`dd_eigh_jacobi` agree with the JAX package's within the JAX test's own
tolerances, and `nt_scale_dd` with the JAX package's in every field, tail
and flag (its tolerances below). The kernels themselves run only on a card
(tests/test_torch_cuda.py); here a model of D2's in-place reduction is
held to `dd_sum`, and the 'auto' rule of the dd NT scaling to the JAX
package's.
"""
import json
import sys

import mpmath as mp
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from loraine_tpu.ops import dd_linalg as jdl
from loraine_tpu.ops import nt_scaling as jnts
from loraine_tpu.ops.dd import DD as JDD
from loraine_tpu_torch.config import Options
from loraine_tpu_torch.ops import dd_linalg as tdl
from loraine_tpu_torch.ops.dd import DD, dd_add, dd_sum, dd_to_f64
from loraine_tpu_torch.ops.dd_linalg import (dd_abs, dd_chol, dd_const, dd_div, dd_eigh_jacobi,
                                             dd_matmul, dd_mul, dd_sqr, dd_sqrt, dd_sym)
from loraine_tpu_torch.ops.eigh import round_robin_pairs
from loraine_tpu_torch.ops.nt_scaling import nt_scale, nt_scale_dd
from torch_cases import sized_problem

mp.mp.dps = 50


def T(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _to_dd(x):
    a = np.array([[float(x[i, j]) for j in range(x.cols)] for i in range(x.rows)])
    lo = np.array([[float(x[i, j] - mp.mpf(a[i, j])) for j in range(x.cols)]
                   for i in range(x.rows)])
    return DD(T(a), T(lo))


def _dd_val(hi, lo):
    return mp.mpf(float(hi)) + mp.mpf(float(lo))


def _rel_err(hi, lo, ref):
    return abs((_dd_val(hi, lo) - ref) / ref) if ref != 0 else abs(_dd_val(hi, lo))


def test_dd_scalar_ops_accuracy():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = rng.standard_normal() * 10.0 ** rng.integers(-8, 8)
        b = rng.standard_normal() * 10.0 ** rng.integers(-8, 8)
        da, db = DD(T(a), T(0.0)), DD(T(b), T(0.0))
        r = dd_mul(da, db)
        assert _rel_err(r.hi, r.lo, mp.mpf(a) * mp.mpf(b)) < 1e-30
        r = dd_div(da, db)
        assert _rel_err(r.hi, r.lo, mp.mpf(a) / mp.mpf(b)) < 1e-29
        r = dd_sqrt(DD(T(abs(a)), T(0.0)))
        assert _rel_err(r.hi, r.lo, mp.sqrt(abs(mp.mpf(a)))) < 1e-29


def test_dd_sqr_and_const():
    """tests/test_dd_linalg.py::test_dd_sqr_alias_safety: 1 + x^2 with |x^2|
    spanning [0, 9], at dd accuracy."""
    rng = np.random.default_rng(4)
    xh = rng.standard_normal(64) * 3.0
    xl = xh * 1e-17 * rng.standard_normal(64)
    sq = dd_sqr(DD(T(xh), T(xl)))
    r = dd_add(dd_const(1.0, sq.hi), sq)
    for i in range(64):
        ref = 1 + (mp.mpf(xh[i]) + mp.mpf(xl[i])) ** 2
        assert _rel_err(r.hi[i], r.lo[i], ref) < 1e-29, i


def test_dd_sqrt_nonpositive_is_zero():
    r = dd_sqrt(DD(T(-3.0), T(0.0)))
    assert float(r.hi) == 0.0 and float(r.lo) == 0.0


def test_dd_abs_and_sym():
    x = DD(T([[-1.0, 2.0], [3.0, -4.0]]), T([[-1e-20, 0.0], [1e-20, 1e-20]]))
    a = dd_abs(x)
    assert (a.hi >= 0).all() and float(a.lo[0, 0]) == 1e-20 and float(a.lo[1, 1]) == -1e-20
    s = dd_sym(x)
    assert torch.equal(s.hi, s.hi.mT) and float(s.hi[0, 1]) == 2.5


def test_dd_matmul_vs_mpmath():
    rng = np.random.default_rng(1)
    m = 9
    A = mp.matrix([[mp.mpf(rng.standard_normal()) + mp.mpf(rng.standard_normal()) * mp.mpf(2) ** -55
                    for _ in range(m)] for _ in range(m)])
    B = mp.matrix([[mp.mpf(rng.standard_normal()) + mp.mpf(rng.standard_normal()) * mp.mpf(2) ** -55
                    for _ in range(m)] for _ in range(m)])
    Add, Bdd = _to_dd(A), _to_dd(B)
    R = dd_matmul(DD(Add.hi[None], Add.lo[None]), DD(Bdd.hi[None], Bdd.lo[None]))
    C = A * B
    scale = max(abs(C[i, j]) for i in range(m) for j in range(m))
    for i in range(m):
        for j in range(m):
            assert abs(_dd_val(R.hi[0, i, j], R.lo[0, i, j]) - C[i, j]) / scale < 1e-28


def _graded_spd(m, span, seed=3):
    """tests/test_dd_linalg.py::_graded_spd: an mpmath SPD matrix with
    eigenvalues spread over 10**-span, already rounded to its dd form."""
    rng = np.random.default_rng(seed)
    Q = mp.matrix(np.linalg.qr(rng.standard_normal((m, m)))[0].tolist())
    d = [mp.mpf(10) ** (-span * i / (m - 1)) * (1 + mp.mpf(rng.standard_normal()) / 10)
         for i in range(m)]
    dd = _to_dd(Q * mp.diag(d) * Q.T)
    hi, lo = dd.hi.numpy(), dd.lo.numpy()
    A_dd = mp.matrix([[mp.mpf(hi[i, j]) + mp.mpf(lo[i, j]) for j in range(m)] for i in range(m)])
    return A_dd, dd


def test_dd_chol_graded():
    m = 10
    A, Add = _graded_spd(m, 20)
    L, ok = dd_chol(DD(Add.hi[None], Add.lo[None]))
    assert bool(ok[0])
    Lmp = mp.cholesky(A)
    for i in range(m):
        for j in range(i + 1):
            ref = Lmp[i, j]
            if abs(ref) < mp.mpf(1e-40):
                continue
            envelope = max(mp.mpf(1e-29) / (Lmp[j, j] ** 2), mp.mpf(1e-28))
            assert _rel_err(L.hi[0, i, j], L.lo[0, i, j], ref) < envelope, (i, j)
    R = dd_matmul(L, DD(L.hi.mT, L.lo.mT))
    for i in range(m):
        for j in range(m):
            assert abs(_dd_val(R.hi[0, i, j], R.lo[0, i, j]) - A[i, j]) < 1e-28, (i, j)
    # the JAX package's factor on the same input, within the same envelope
    Lj, okj = jdl.dd_chol(JDD(jnp.asarray(Add.hi.numpy())[None], jnp.asarray(Add.lo.numpy())[None]))
    assert bool(okj[0])
    for i in range(m):
        for j in range(i + 1):
            ref = _dd_val(Lj.hi[0, i, j], Lj.lo[0, i, j])
            if abs(ref) < mp.mpf(1e-40):
                continue
            envelope = max(mp.mpf(1e-29) / (Lmp[j, j] ** 2), mp.mpf(1e-28))
            assert _rel_err(L.hi[0, i, j], L.lo[0, i, j], ref) < 2 * envelope, (i, j)


def test_dd_chol_reports_indefinite():
    _, ok = dd_chol(DD(T(np.diag([1.0, -1e-30, 1.0]))[None], torch.zeros((1, 3, 3), dtype=torch.float64)))
    assert not bool(ok[0])
    L, ok = dd_chol(DD(T(np.diag([1.0, 0.0, 1.0]))[None], T(np.diag([0.0, 1e-25, 0.0]))[None]))
    assert bool(ok[0])
    assert abs(_dd_val(L.hi[0, 1, 1], L.lo[0, 1, 1]) - mp.sqrt(mp.mpf(1e-25))) < 1e-40


def test_round_robin_pairs_matches_jax():
    from loraine_tpu.ops.eigh import round_robin_pairs as jrr

    for m in (2, 8, 16):
        assert np.array_equal(round_robin_pairs(m), jrr(m))


def _eigs(A, m):
    E, _ = mp.eigsy(A)
    return sorted([E[i] for i in range(m)])


def test_dd_eigh_graded_beyond_f64():
    m = 8
    A, Add = _graded_spd(m, 20, seed=5)
    M = DD(Add.hi[None], Add.lo[None])
    lam, V = dd_eigh_jacobi(M)
    refs = _eigs(A, m)
    for i in range(m):
        assert abs(_dd_val(lam.hi[0, i], lam.lo[0, i]) - refs[i]) < 1e-29, i
    assert _rel_err(lam.hi[0, -1], lam.lo[0, -1], refs[-1]) < 1e-26
    lam64 = np.linalg.eigvalsh(M.hi[0].numpy())
    assert abs(lam64[0] - float(refs[0])) > 100 * abs(float(_dd_val(lam.hi[0, 0], lam.lo[0, 0]) - refs[0]))
    VtV = dd_matmul(DD(V.hi.mT, V.lo.mT), V)
    assert np.abs(dd_to_f64(VtV)[0].numpy() - np.eye(m)).max() < 1e-28
    # the JAX package on the same input: the same eigenvalues to the
    # oracle's tolerance
    lj, _ = jdl.dd_eigh_jacobi(JDD(jnp.asarray(Add.hi.numpy())[None], jnp.asarray(Add.lo.numpy())[None]))
    for i in range(m):
        assert abs(_dd_val(lam.hi[0, i], lam.lo[0, i]) - _dd_val(lj.hi[0, i], lj.lo[0, i])) < 2e-29, i


def test_dd_eigh_warm_start_matches_cold():
    m = 12
    A, Add = _graded_spd(m, 16, seed=7)
    M = DD(Add.hi[None], Add.lo[None])
    lam_cold, _ = dd_eigh_jacobi(M)
    V0 = torch.linalg.eigh(M.hi[0])[1][None]
    lam_warm, _ = dd_eigh_jacobi(M, V0=V0)
    refs = _eigs(A, m)
    for i in range(m):
        assert abs(_dd_val(lam_warm.hi[0, i], lam_warm.lo[0, i]) - refs[i]) < 1e-29, i
        assert abs(_dd_val(lam_cold.hi[0, i], lam_cold.lo[0, i]) - refs[i]) < 1e-29, i


@pytest.mark.parametrize("m", [7])
def test_dd_eigh_odd_size(m):
    A, Add = _graded_spd(m, 10, seed=9)
    lam, V = dd_eigh_jacobi(DD(Add.hi[None], Add.lo[None]))
    assert lam.hi.shape == (1, m) and V.hi.shape == (1, m, m)
    refs = _eigs(A, m)
    for i in range(m):
        assert abs(_dd_val(lam.hi[0, i], lam.lo[0, i]) - refs[i]) < 1e-29, i


def _stack_dd(parts):
    return DD(torch.stack([p.hi for p in parts]), torch.stack([p.lo for p in parts]))


@pytest.mark.parametrize("backend", ["jacobi", "auto"])
def test_nt_scale_dd_identities_beyond_f64(backend):
    """tests/test_dd_linalg.py::test_nt_scale_dd_identities_beyond_f64 with
    its bounds: X with a spectrum down to ~1e-16 (below f64 absolute
    resolution), so the f64 D is formation noise on the small end, while
    the dd scaling keeps D to 1e-14 relative across the whole spectrum
    and W S W = X, G^T S G = diag(D) to dd class. 'jacobi' is the JAX
    test's warm start; 'auto' the port's default (B1's plain version on the
    CPU, then the f64 refinement)."""
    m = 8
    Xmp, Xdd = _graded_spd(m, 16, seed=11)
    Smp, Sdd = _graded_spd(m, 12, seed=13)
    X, S = _stack_dd([Xdd]), _stack_dd([Sdd])
    backend = Options(eigh_backend=backend).resolved(sized_problem(m), "cpu").eigh_backend
    nts, tails = nt_scale_dd(X, S, eigh_backend=backend)
    assert bool(tails.dd_ok)

    E, _ = mp.eigsy(mp.cholesky(Xmp).T * Smp * mp.cholesky(Xmp))
    refs = sorted([mp.sqrt(E[i]) for i in range(m)])
    for i in range(m):
        rel = abs((_dd_val(nts.D[0, i], tails.D_lo[0, i]) - refs[i]) / refs[i])
        assert rel < 1e-14, (i, float(rel))
    base = nt_scale(X.hi, S.hi, method="eigh", eigh_backend=backend)
    f64_rel = abs((mp.mpf(float(base.D[0, 0])) - refs[0]) / refs[0])
    got0 = _dd_val(nts.D[0, 0], tails.D_lo[0, 0])
    assert f64_rel > 1e4 * abs((got0 - refs[0]) / refs[0])

    W = DD(nts.W, tails.W_lo)
    WSW = dd_matmul(W, dd_matmul(S, W))
    scale = float(X.hi.abs().max())
    assert float((dd_to_f64(WSW) - dd_to_f64(X)).abs().max()) < 1e-25 * scale

    G = DD(nts.G, tails.G_lo)
    GSG = dd_to_f64(dd_matmul(DD(G.hi.mT, G.lo.mT), dd_matmul(S, G)))[0]
    offdiag = GSG - torch.diag(torch.diag(GSG))
    assert float(offdiag.abs().max()) < 1e-25 * float(GSG.abs().max())

    # fallback: an X indefinite at dd resolution selects the f64 result with
    # zero tails and dd_ok False
    Xbad_hi = X.hi.clone()
    Xbad_hi[0, -1, -1] = -1.0
    Xbad, Sgood = DD(Xbad_hi, torch.zeros_like(X.lo)), DD(S.hi, torch.zeros_like(S.lo))
    nts_b, tails_b = nt_scale_dd(Xbad, Sgood, eigh_backend=backend)
    assert not bool(tails_b.dd_ok)
    base = nt_scale(Xbad.hi, Sgood.hi, method="eigh", eigh_backend=backend)
    np.testing.assert_allclose(nts_b.W.numpy(), base.W.numpy())
    assert float(tails_b.W_lo.abs().max()) == 0.0


def _nt_case(case):
    """Two graded dd iterates per batch (X spectra down to 1e-16, S to
    1e-12) at m = 8 or the odd m = 7; 'fallback': the m = 8 batch with one
    block of X indefinite, so every block takes the f64 scaling."""
    m = 7 if case == "m7" else 8
    X = _stack_dd([_graded_spd(m, 16, seed=s)[1] for s in (11, 12)])
    S = _stack_dd([_graded_spd(m, 12, seed=s)[1] for s in (13, 14)])
    if case == "fallback":
        hi = X.hi.clone()
        hi[1, -1, -1] = -1.0
        X = DD(hi, X.lo)
    return X, S


@pytest.mark.parametrize("case", ["m8", "m7", "fallback"])
def test_nt_scale_dd_matches_jax(case):
    """`nt_scale_dd` against the JAX package's on the same dd iterates, both
    warm-started by their f64 Jacobi ('jacobi'): the flags equal; D + D_lo
    within the identities test's 1e-14 relative per entry; G + G_lo and
    W + W_lo within 1e-17 of their scale (measured on the CPU: 7e-20 and
    5e-21, the graded dd Cholesky's forward error); Gi, Si and DDsi, formed
    from the hi words, within 1e-13 of their scale (measured 7e-17). In the
    fallback each package returns its own f64 `nt_scale`, bit for bit, with
    zero tails (the two f64 scalings differ by formation noise on the small
    end of the graded spectrum, and the indefinite block is NaN in both)."""
    X, S = _nt_case(case)
    nts, tails = nt_scale_dd(X, S, eigh_backend="jacobi")
    jX = JDD(jnp.asarray(X.hi.numpy()), jnp.asarray(X.lo.numpy()))
    jS = JDD(jnp.asarray(S.hi.numpy()), jnp.asarray(S.lo.numpy()))
    jn, jt = jnts.nt_scale_dd(jX, jS, eigh_backend="jacobi")
    assert bool(tails.dd_ok) == bool(jt.dd_ok) == (case != "fallback")
    for f in ("ok", "shifted", "s_indef"):
        assert bool(getattr(nts, f)) == bool(getattr(jn, f)), f
    if case == "fallback":
        base = nt_scale(X.hi, S.hi, method="eigh", eigh_backend="jacobi")
        jbase = jnts.nt_scale(jX.hi, jS.hi, method="eigh", eigh_backend="jacobi")
        for f in ("D", "G", "Gi", "W", "Si", "DDsi"):
            np.testing.assert_array_equal(getattr(nts, f).numpy(), getattr(base, f).numpy())
            np.testing.assert_array_equal(np.asarray(getattr(jn, f)), np.asarray(getattr(jbase, f)))
        for lo in ("D_lo", "G_lo", "W_lo"):
            assert float(getattr(tails, lo).abs().max()) == 0.0
            assert float(np.abs(np.asarray(getattr(jt, lo))).max()) == 0.0
        return
    D, Dj = nts.D.numpy() + tails.D_lo.numpy(), np.asarray(jn.D) + np.asarray(jt.D_lo)
    assert np.abs((D - Dj) / Dj).max() <= 1e-14
    for f, lo in (("G", "G_lo"), ("W", "W_lo")):
        a, b = getattr(nts, f).numpy(), np.asarray(getattr(jn, f))
        diff = (a - b) + (getattr(tails, lo).numpy() - np.asarray(getattr(jt, lo)))
        assert np.abs(diff).max() <= 1e-17 * np.abs(b).max(), f
    for f in ("Gi", "Si", "DDsi"):
        a, b = getattr(nts, f).numpy(), np.asarray(getattr(jn, f))
        assert np.abs(a - b).max() <= 1e-13 * np.abs(b).max(), f


def _dd_batch(x, rng):
    """A dd batch from numpy: hi = x, lo ~ 1e-17 of it."""
    return DD(T(x), T(x * 1e-17 * rng.standard_normal(x.shape)))


def test_dd_matmul_plain_matches_jax():
    """D3's plain version (every term in dd, ascending k) against the JAX
    package's `dd_matmul` (Ozaki slices, truncated at 2^-106 of the |A||B|
    scale) within 1e-28 of |A||B|, a batch of two with a broadcast operand
    and a transposed view; `dd_matmul` on a CPU tensor is the plain
    version."""
    rng = np.random.default_rng(21)
    A = _dd_batch(rng.standard_normal((2, 7, 9)) * np.logspace(-3, 3, 9), rng)
    B = _dd_batch(rng.standard_normal((1, 9, 5)), rng)
    C = tdl.dd_matmul_plain(A, B)
    assert C.hi.shape == (2, 7, 5)
    Cj = jdl.dd_matmul(JDD(jnp.asarray(A.hi.numpy()), jnp.asarray(A.lo.numpy())),
                       JDD(jnp.asarray(B.hi.numpy()), jnp.asarray(B.lo.numpy())))
    scale = np.abs(A.hi.numpy()) @ np.abs(B.hi.numpy())
    diff = (C.hi.numpy() - np.asarray(Cj.hi)) + (C.lo.numpy() - np.asarray(Cj.lo))
    assert np.abs(diff / scale).max() < 1e-28
    R = dd_matmul(A, B)
    assert torch.equal(R.hi, C.hi) and torch.equal(R.lo, C.lo)
    At = tdl.dd_transpose(_dd_batch(rng.standard_normal((2, 9, 7)), rng))
    Ct = tdl.dd_matmul_plain(At, B)
    Ctj = jdl.dd_matmul(JDD(jnp.asarray(At.hi.numpy()), jnp.asarray(At.lo.numpy())),
                        JDD(jnp.asarray(B.hi.numpy()), jnp.asarray(B.lo.numpy())))
    scale = np.abs(At.hi.numpy()) @ np.abs(B.hi.numpy())
    diff = (Ct.hi.numpy() - np.asarray(Ctj.hi)) + (Ct.lo.numpy() - np.asarray(Ctj.lo))
    assert np.abs(diff / scale).max() < 1e-28


@pytest.mark.parametrize("warm", [False, True])
def test_dd_eigh_matches_jax(warm):
    """`dd_eigh_jacobi` (D1's plain version for the sweeps, D3's in the warm
    start) against the JAX package's on the same input, nb = 2 at the odd
    m = 7 (the padding), cold and warm-started from the same f64 basis: the
    eigenvalues within 2e-29 absolute, and the port's V^T V - I within
    1e-28."""
    m = 7
    parts = [_graded_spd(m, 12, seed=s)[1] for s in (31, 32)]
    M = _stack_dd(parts)
    V0 = torch.linalg.eigh(M.hi)[1] if warm else None
    lam, V = dd_eigh_jacobi(M, V0=V0)
    lj, _ = jdl.dd_eigh_jacobi(JDD(jnp.asarray(M.hi.numpy()), jnp.asarray(M.lo.numpy())),
                               V0=None if V0 is None else jnp.asarray(V0.numpy()))
    got = lam.hi.numpy() + lam.lo.numpy()
    ref = np.asarray(lj.hi) + np.asarray(lj.lo)
    diff = (lam.hi.numpy() - np.asarray(lj.hi)) + (lam.lo.numpy() - np.asarray(lj.lo))
    assert got.shape == ref.shape == (2, m)
    assert np.abs(diff).max() < 2e-29
    VtV = dd_to_f64(dd_matmul(tdl.dd_transpose(V), V)).numpy()
    assert np.abs(VtV - np.eye(m)).max() < 1e-28


@pytest.mark.parametrize("m", [1, 2, 7, 8, 56])
def test_chol_kernel_tree_equals_dd_sum(m):
    """D2 sums each row's products in place, one level of `dd_sum`'s tree a
    barrier: slot k takes dd_add(P[k], P[k + half]) and, at an odd length n,
    slot 0 then adds P[n - 1]. A model of that loop equals `dd_sum` bit for
    bit on cancelling, widely spread data (so the kernel's reduction is
    the plain version's)."""
    rng = np.random.default_rng(m)
    hi = rng.standard_normal((3, m)) * 2.0 ** rng.integers(-60, 60, (3, m))
    hi[:, 1::2] = -hi[:, ::2][:, : m // 2]
    x = DD(T(hi), T(hi * 2.0**-55 * rng.standard_normal((3, m))))
    P = [DD(x.hi[:, k], x.lo[:, k]) for k in range(m)]
    n = m
    while n > 1:
        half = n // 2
        for k in range(half):
            acc = dd_add(P[k], P[k + half])
            if n % 2 and k == 0:
                acc = dd_add(acc, P[n - 1])
            P[k] = acc
        n = half
    ref = dd_sum(x, axis=-1)
    assert torch.equal(P[0].hi, ref.hi) and torch.equal(P[0].lo, ref.lo)


# ---- models of the kernels' orders (csrc/dd_linalg.cu), in torch on the CPU


def _tournament(m):
    """The .cu's tournament arithmetic as numpy functions: the label at
    position k of round r, the position of label x, a row's next position,
    the pair of a position, and (owner CTA, slot) of a position under C."""
    def label_at(k, r):
        u = k - 1 + r
        return np.where(k == 0, 0, 1 + np.where(u >= m - 1, u - (m - 1), u))

    def pos_of(x, r):
        u = x - 1 - r
        return np.where(x == 0, 0, 1 + np.where(u < 0, u + (m - 1), u))

    def next_pos(k):
        return np.where(k == 0, 0, np.where(k == 1, m - 1, k - 1))

    def pair_of(k):
        return np.where(k < m // 2, k, m - 1 - k)

    def slot_of(k, C):
        h, pi = m // 2, pair_of(k)
        owner = ((pi + 1) * C - 1) // h
        return owner, 2 * (pi - owner * h // C) + (k >= h)

    return label_at, pos_of, next_pos, pair_of, slot_of


def _dsel(cond, x, y):
    return DD(torch.where(cond, x.hi, y.hi), torch.where(cond, x.lo, y.lo))


def _d1_model(A, V, sweeps):
    """D1's order on [nb, m, m]: rows by tournament position in two buffers;
    each 2x2 block (own pair t, column pair k) through the column step and
    then the row step, written to its rows' next positions; each next angle
    from the three blocks it needs (`rotated`, from the round's buffer and
    angles); dd_sym after a sweep with the next sweep's first angles from
    the unsymmetrized rows. Returns (A, V)."""
    nb, m, _ = A.hi.shape
    h = m // 2
    label_at, pos_of, next_pos, pair_of, _ = _tournament(m)
    k = np.arange(h)

    def g(X, rows, cols):  # X[:, rows, cols] with broadcast index arrays
        return DD(X.hi[:, rows, cols], X.lo[:, rows, cols])

    def rotated(axy, axyy, axxy, axxyy, cx, sx, cy, sy):
        bx = dd_add(dd_mul(cy, axy), dd_mul(sy, axyy))
        bxx = dd_add(dd_mul(cy, axxy), dd_mul(sy, axxyy))
        return dd_add(dd_mul(cx, bx), dd_mul(sx, bxx))

    def half(u):
        return DD(0.5 * u.hi, 0.5 * u.lo)

    def neg_if(cond, x):  # cond [h] numpy, x [nb, h]
        c = torch.as_tensor(cond)
        return DD(torch.where(c, -x.hi, x.hi), torch.where(c, -x.lo, x.lo))

    X, V = DD(A.hi.clone(), A.lo.clone()), DD(V.hi.clone(), V.lo.clone())
    p, q = k, m - 1 - k
    c, s = tdl._rotation(g(X, p, p), g(X, q, q), g(X, p, q))
    for sw in range(sweeps):
        for r in range(m - 1):
            top, bot = label_at(k, r), label_at(m - 1 - k, r)
            cp, cq = np.minimum(top, bot), np.maximum(top, bot)
            if r < m - 2:  # the next angles, from this round's buffer
                a, b = label_at(k, r + 1), label_at(m - 1 - k, r + 1)
                pn, qn = np.minimum(a, b), np.maximum(a, b)
                kp, kq = pos_of(pn, r), pos_of(qn, r)
                pp, qq = label_at(m - 1 - kp, r), label_at(m - 1 - kq, r)
                cP, sP = DD(c.hi[:, pair_of(kp)], c.lo[:, pair_of(kp)]), \
                    DD(s.hi[:, pair_of(kp)], s.lo[:, pair_of(kp)])
                cQ, sQ = DD(c.hi[:, pair_of(kq)], c.lo[:, pair_of(kq)]), \
                    DD(s.hi[:, pair_of(kq)], s.lo[:, pair_of(kq)])
                sp, sq = neg_if(pn < pp, sP), neg_if(qn < qq, sQ)
                rp, rpp, rq, rqq = kp, m - 1 - kp, kq, m - 1 - kq
                app = rotated(g(X, rp, pn), g(X, rp, pp), g(X, rpp, pn), g(X, rpp, pp), cP, sp, cP, sp)
                aqq = rotated(g(X, rq, qn), g(X, rq, qq), g(X, rqq, qn), g(X, rqq, qq), cQ, sq, cQ, sq)
                apq = rotated(g(X, rp, qn), g(X, rp, qq), g(X, rpp, qn), g(X, rpp, qq), cP, sp, cQ, sq)
                nxt = tdl._rotation(app, aqq, apq)
            # the blocks: rows (k, m-1-k) x columns (cp, cq)
            cc = DD(c.hi[:, None, :], c.lo[:, None, :])
            sc = DD(s.hi[:, None, :], s.lo[:, None, :])
            nsc = DD(-sc.hi, -sc.lo)
            cr = DD(c.hi[:, :, None], c.lo[:, :, None])
            sr = DD(s.hi[:, :, None], s.lo[:, :, None])
            first = torch.as_tensor(top < bot)[None, :, None]
            s1 = _dsel(first, DD(-sr.hi, -sr.lo), sr)
            s2 = _dsel(first, sr, DD(-sr.hi, -sr.lo))
            r1, r2 = k[:, None], (m - 1 - k)[:, None]
            a1p, a1q = g(X, r1, cp[None, :]), g(X, r1, cq[None, :])
            a2p, a2q = g(X, r2, cp[None, :]), g(X, r2, cq[None, :])
            b1p = dd_add(dd_mul(cc, a1p), dd_mul(nsc, a1q))
            b1q = dd_add(dd_mul(cc, a1q), dd_mul(sc, a1p))
            b2p = dd_add(dd_mul(cc, a2p), dd_mul(nsc, a2q))
            b2q = dd_add(dd_mul(cc, a2q), dd_mul(sc, a2p))
            Y = DD(torch.empty_like(X.hi), torch.empty_like(X.lo))
            w1, w2 = next_pos(k)[:, None], next_pos(m - 1 - k)[:, None]
            for rows, col, val in ((w1, cp, dd_add(dd_mul(cr, b1p), dd_mul(s1, b2p))),
                                   (w1, cq, dd_add(dd_mul(cr, b1q), dd_mul(s1, b2q))),
                                   (w2, cp, dd_add(dd_mul(cr, b2p), dd_mul(s2, b1p))),
                                   (w2, cq, dd_add(dd_mul(cr, b2q), dd_mul(s2, b1q)))):
                Y.hi[:, rows, col[None, :]] = val.hi
                Y.lo[:, rows, col[None, :]] = val.lo
            vc = DD(c.hi[:, None, :], c.lo[:, None, :])
            vp, vq = DD(V.hi[:, :, cp], V.lo[:, :, cp]), DD(V.hi[:, :, cq], V.lo[:, :, cq])
            V = DD(V.hi.clone(), V.lo.clone())
            for col, val in ((cp, dd_add(dd_mul(vc, vp), dd_mul(nsc, vq))),
                             (cq, dd_add(dd_mul(vc, vq), dd_mul(sc, vp)))):
                V.hi[:, :, col] = val.hi
                V.lo[:, :, col] = val.lo
            X = Y
            if r < m - 2:
                c, s = nxt
        # positions = labels again: dd_sym, and the next sweep's first angles
        app, aqq = g(X, p, p), g(X, q, q)
        c, s = tdl._rotation(half(dd_add(app, app)), half(dd_add(aqq, aqq)),
                             half(dd_add(g(X, p, q), g(X, q, p))))
        X = half(dd_add(X, DD(X.hi.mT, X.lo.mT)))
    return X, V


@pytest.mark.parametrize("nb,m,sweeps", [(2, 8, 2), (1, 56, 1)])
def test_d1_block_order_equals_plain(nb, m, sweeps):
    """A torch model of D1's order (`_d1_model`: the 2x2 blocks through the
    column step and the row step in registers, the rows moving by
    tournament position between two buffers, the next angles recomputed
    from three blocks a pair, dd_sym's angles from the unsymmetrized rows)
    equals `dd_jacobi_plain` bit for bit on A and V."""
    rng = np.random.default_rng(m)
    A0 = rng.standard_normal((nb, m, m))
    A = DD(T(A0 + A0.transpose(0, 2, 1)), T(1e-17 * rng.standard_normal((nb, m, m))))
    V = DD(T(np.linalg.qr(rng.standard_normal((nb, m, m)))[0]),
           T(1e-17 * rng.standard_normal((nb, m, m))))
    got = _d1_model(A, V, sweeps)
    ref = tdl.dd_jacobi_plain(A, V, sweeps)
    for x, y in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("m", [2, 8, 18, 56, 194, 266])
def test_d1_cluster_tables(m):
    """D1's tournament arithmetic and row ownership: `label_at` is
    `round_robin_pairs` (pair k = positions k and m - 1 - k); each round
    moves every label one position on (`pos_of`, `next_pos`); under every
    cluster size that fits m both rows of each pair sit in one CTA, every
    position has one (CTA, slot) and every CTA's slots are 0 .. 2 np - 1
    (np its pairs, at most `jacobi_rows`), and a round moves rows only to
    the neighbouring CTAs, at most one each way."""
    label_at, pos_of, next_pos, pair_of, slot_of = _tournament(m)
    pairs = round_robin_pairs(m)
    h, ks = m // 2, np.arange(m)
    for r in range(m - 1):
        assert (label_at(ks[:h], r) == pairs[r, 0]).all()
        assert (label_at(m - 1 - ks[:h], r) == pairs[r, 1]).all()
        assert (pos_of(label_at(ks, r), r) == ks).all()
        # the row at position k in round r is at next_pos(k) in round r + 1
        assert (label_at(next_pos(ks), r + 1) == label_at(ks, r)).all()
    for C in sorted({c for c in (1, 2, 4, 7, 8, 14, 16) if c <= h}):
        owner, slot = slot_of(ks, C)
        assert (owner == slot_of(m - 1 - ks, C)[0]).all()  # both rows of a pair
        rows = 2 * ((h + C - 1) // C)
        for b in range(C):
            npb = (b + 1) * h // C - b * h // C
            assert npb >= 1 and sorted(slot[owner == b]) == list(range(2 * npb))
            assert 2 * npb <= rows
        moved = owner[next_pos(ks)] - owner
        assert set(np.abs(moved)) <= {0, 1}
        for b in range(C):
            assert (owner[moved == 1] == b).sum() <= 1 and (owner[moved == -1] == b).sum() <= 1


def _d2_tree(P, j):
    """D2's tree of one row at column j in the "warp" regime, over rows of
    P (dd [B, m], one j per row, P[:, k] = (+0, +0) for k >= j: the columns
    not computed yet): level 0 slot s = dd_add(P[s], P[s + m/2]) (slot 0
    then adds the zero P[m - 1] at an odd m), each further level slot k =
    dd_add(S[k], S[k + half]) (slot 0 adding S[n - 1] at an odd n); a slot
    k >= j is never computed and reads as (+0, +0). Returns slot 0."""
    B, m = P.hi.shape
    zero = DD(torch.zeros(B, dtype=P.hi.dtype), torch.zeros(B, dtype=P.hi.dtype))

    def pick(k, v):  # slot k as D2 holds it
        live = k < j
        return DD(torch.where(live, v.hi, 0.0), torch.where(live, v.lo, 0.0))

    if m == 1:
        return zero
    half0 = m // 2
    S = []
    for s in range(half0):
        v = dd_add(DD(P.hi[:, s], P.lo[:, s]), pick(s + half0, DD(P.hi[:, s + half0],
                                                                   P.lo[:, s + half0])))
        if m % 2 and s == 0:
            v = dd_add(v, zero)
        S.append(pick(s, v))
    n = half0
    while n > 1:
        half = n // 2
        for k in range(half):
            v = dd_add(S[k], S[k + half])
            if n % 2 and k == 0:
                v = dd_add(v, S[n - 1])
            S[k] = pick(k, v)
        n = half
    return pick(0, S[0])


@pytest.mark.parametrize("m", [1, 2, 3, 7, 8, 33, 56, 57, 64, 65, 104, 105])
def test_chol_warp_tree_equals_dd_sum(m):
    """D2's "warp" regime sums a row's products in its own slot array and
    skips the slots that are exact zeros at column j (`_d2_tree`): at every
    j it equals `dd_sum` over all m products bit for bit, on cancelling,
    widely spread data with signed zeros, as the in-place loop of
    `test_chol_kernel_tree_equals_dd_sum` does for "global"."""
    rng = np.random.default_rng(m)
    j = np.repeat(np.arange(m), 2)
    hi = rng.standard_normal((2 * m, m)) * 2.0 ** rng.integers(-60, 60, (2 * m, m))
    hi[:, 1::2] = -hi[:, ::2][:, : m // 2]
    lo = hi * 2.0**-55 * rng.standard_normal((2 * m, m))
    lo[rng.random((2 * m, m)) < 0.2] = -0.0
    hi[rng.random((2 * m, m)) < 0.1] = -0.0
    tail = np.arange(m)[None, :] >= j[:, None]
    hi[tail], lo[tail] = 0.0, 0.0
    x = DD(T(hi), T(lo))
    got, ref = _d2_tree(x, torch.as_tensor(j)), dd_sum(x, axis=-1)
    assert torch.equal(got.hi, ref.hi) and torch.equal(got.lo, ref.lo)


@pytest.mark.parametrize("m", [2, 8, 56])
def test_dd_jacobi_rounds(m):
    """D1's rounds put p = min and q = max of every pair of
    `round_robin_pairs` and cover each unordered pair once a sweep; every
    index's partner and its slot in cat(p, q) are inverse tables."""
    p, q, partner, pos = tdl._jacobi_rounds(m)
    assert (p < q).all() and p.shape == (m - 1, m // 2)
    seen = {(int(a), int(b)) for r in range(m - 1) for a, b in zip(p[r], q[r])}
    assert len(seen) == m * (m - 1) // 2
    for r in range(m - 1):
        assert (partner[r, partner[r]] == np.arange(m)).all()
        assert (np.concatenate([p[r], q[r]])[pos[r]] == np.arange(m)).all()


def test_dd_routes_refuse_other_devices():
    """The routes take the plain version on the CPU and the kernel on CUDA;
    any other device raises."""
    x = torch.zeros((1, 4, 4), dtype=torch.float64, device="meta")
    for call in (lambda: dd_matmul(DD(x, x), DD(x, x)), lambda: dd_chol(DD(x, x)),
                 lambda: dd_eigh_jacobi(DD(x, x), sweeps=1)):
        with pytest.raises(ValueError, match="no dd linear-algebra route"):
            call()


@pytest.mark.parametrize("precision", ["f64", "dd", "dd2"])
def test_nt_precision_auto_rule(precision):
    """nt_precision 'auto' resolves as the JAX package's
    (`loraine_tpu/ipm/step.py:367-370`) with the card in the TPU's place:
    the dd NT scaling only under 'dd2' on a CUDA device, the f64 one on the
    CPU in every tier, and on the CG path (kit=1) on the card too (ROADMAP
    Queue C 8); 'dd' and 'f64' stand on both paths (a pure function: no
    card needed)."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")

    def nt_dd_for(o, device):
        return o.resolved(sized_problem(10), device).nt_precision == "dd"

    for kit in (0, 1):
        o = Options(precision=precision, kit=kit)
        assert nt_dd_for(o, cpu) is False
        assert nt_dd_for(o, cuda) is (precision == "dd2" and kit == 0)
        for dev in (cpu, cuda):
            assert nt_dd_for(Options(precision=precision, kit=kit, nt_precision="f64"),
                             dev) is False
            assert nt_dd_for(Options(precision=precision, kit=kit, nt_precision="dd"),
                             dev) is (precision == "dd2")


def test_probe_iterates_scale_alike(tmp_path, capsys):
    """`utils/cg_dd2_probe.py`'s file of scaled iterates, written from the
    port's `nt_scale_dd` on the CPU, and the script below on it: the JAX
    package's scaling of the same iterates agrees with the saved D and W
    within `test_nt_scale_dd_matches_jax`'s tolerances."""
    from loraine_tpu_torch.utils import cg_dd2_probe

    X, S = _nt_case("m8")
    calls = [(X, S, *nt_scale_dd(X, S, eigh_backend="jacobi"))]
    out = tmp_path / "iterates.npz"
    cg_dd2_probe.save(str(out), calls)
    jax_scale_saved(str(out))
    (rec,) = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rec["dd_ok"] == rec["jax_dd_ok"] is True
    assert rec["D_rel"] <= 1e-14 and rec["W_rel"] <= 1e-17


def jax_scale_saved(path: str) -> None:
    """The script: the JAX package's `nt_scale_dd` (warm start 'jacobi') on
    each iterate of a `cg_dd2_probe` file, one JSON line each: dd_ok in both
    packages, the largest relative difference of D + D_lo from the saved
    one, and that of W + W_lo over max |W|."""
    data = np.load(path)
    for k in range(len(data["dd_ok"])):
        jX = JDD(jnp.asarray(data["X_hi"][k]), jnp.asarray(data["X_lo"][k]))
        jS = JDD(jnp.asarray(data["S_hi"][k]), jnp.asarray(data["S_lo"][k]))
        jn, jt = jnts.nt_scale_dd(jX, jS, eigh_backend="jacobi")
        D = data["D_hi"][k] + data["D_lo"][k]
        Dj = np.asarray(jn.D) + np.asarray(jt.D_lo)
        W = data["W_hi"][k]
        dW = (W - np.asarray(jn.W)) + (data["W_lo"][k] - np.asarray(jt.W_lo))
        print(json.dumps({"k": k, "dd_ok": bool(data["dd_ok"][k]), "jax_dd_ok": bool(jt.dd_ok),
                          "D_rel": float(np.abs((D - Dj) / Dj).max()),
                          "W_rel": float(np.abs(dW).max() / np.abs(W).max()),
                          "D_min": float(D.min())}), flush=True)


if __name__ == "__main__":
    jax_scale_saved(sys.argv[1])
