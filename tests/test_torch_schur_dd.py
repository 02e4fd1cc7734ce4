"""The double-double Schur and data operators of loraine_tpu_torch.ops.schur
against the exact rational oracles of tests/test_schur_dd.py and against
the JAX package, in every storage (dense, rank-1, sparse) and for the LP
block.

The oracles are the JAX test's, with its tolerances. Against the JAX
package the same problem (built by the JAX package, carried across by
`convert.problem_from_numpy`) and the same seeded W, G, M, y go through
both: the dd results agree to within 1e-28 of their scale (1e-27 for the
Schur matrices; 1e-14 for the rank-1 `Aop_dd`, which starts from the f64
product B M in both packages). Not bit for bit: the f64 GEMMs and sums
outside the Ozaki products, and the sparse adjoint's reduction tree, run
in another order.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loraine_tpu as lt
from loraine_tpu.ops import schur as js
from loraine_tpu.ops.dd import DD as JDD
from loraine_tpu.problem import ensure_dd_aadj
from loraine_tpu_torch.convert import problem_from_numpy
from loraine_tpu_torch.ops import schur as ts
from loraine_tpu_torch.ops.dd import DD

rng = np.random.default_rng(3)


def _frac(x):
    return Fraction(float(x))


def _mk(n=6, m=8, rank1=False, seed=3):
    r = np.random.default_rng(seed)
    A = r.standard_normal((n, m, m))
    A = (A + A.transpose(0, 2, 1)) / 2
    if rank1:
        b = r.standard_normal((n, m))
        A = np.einsum("jm,jp->jmp", b, b)
    C = r.standard_normal((m, m))
    C = (C + C.T) / 2
    return A, C, r.standard_normal(n)


def _pair(As, Cs, b, **kw):
    """(JAX problem, the port's copy of it on the CPU)."""
    pj = lt.problem_from_dense(As, Cs, b, **kw)
    return pj, problem_from_numpy(jax.device_get(pj), device="cpu")


def _sparse_data(n, m, seed, entries=3, rows=4):
    """Few-entry symmetric data with many cell collisions
    (tests/test_schur_dd.py:93-103)."""
    r = np.random.default_rng(seed)
    A = np.zeros((n, m, m))
    for j in range(n):
        for _ in range(entries):
            a, c = r.integers(0, rows, 2)
            v = r.standard_normal()
            A[j, a, c] += v
            if a != c:
                A[j, c, a] += v
        A[j, j % m, j % m] += 1.0
    return A


def _spd(m, seed, shift=1.0):
    r = np.random.default_rng(seed)
    W = r.standard_normal((1, m, m))
    return W @ W.transpose(0, 2, 1) + shift * np.eye(m)


def _close(t: DD, j, rel=1e-28):
    """|t - j| (as dd values) within rel of max |j|."""
    th, tl = t.hi.numpy(), t.lo.numpy()
    jh, jl = np.asarray(j.hi), np.asarray(j.lo)
    diff = (th - jh) + (tl - jl)
    return np.abs(diff).max() <= rel * max(np.abs(jh).max(), 1e-300)


def test_aop_dd_matches_exact():
    A, C, b = _mk()
    _, pt = _pair([A], [C], b, storage="dense")
    g = pt.groups[0]
    M = rng.standard_normal((1, g.m, g.m))
    got = ts.Aop_dd(g, torch.from_numpy(M))
    Ad = g.A.numpy()
    for j in [0, 3, 5]:
        exact = sum((_frac(Ad[0, j, a, c]) * _frac(M[0, a, c])
                     for a in range(g.m) for c in range(g.m)), Fraction(0))
        err = abs(_frac(got.hi[j]) + _frac(got.lo[j]) - exact)
        assert err <= abs(exact) * Fraction(1, 10**25) + Fraction(1, 10**28)


def test_schur_group_dd_dense_vs_exact():
    A, C, b = _mk()
    _, pt = _pair([A], [C], b, storage="dense")
    g = pt.groups[0]
    m = g.m
    W = _spd(m, 5)
    G = np.linalg.cholesky(W)
    Hdd = ts.schur_group_dd(g, torch.from_numpy(W), torch.from_numpy(G))
    Ad = g.A.numpy()
    for j, k in [(0, 0), (2, 4)]:
        WA = [[sum((_frac(W[0, a, t]) * _frac(Ad[0, k, t, c]) for t in range(m)), Fraction(0))
               for c in range(m)] for a in range(m)]
        WAW = [[sum((WA[a][t] * _frac(W[0, t, c]) for t in range(m)), Fraction(0))
                for c in range(m)] for a in range(m)]
        exact = sum((_frac(Ad[0, j, a, c]) * WAW[a][c] for a in range(m) for c in range(m)),
                    Fraction(0))
        got = _frac(Hdd.hi[j, k]) + _frac(Hdd.lo[j, k])
        assert abs(got - exact) <= abs(exact) * Fraction(1, 10**24)
    Hf = ts.schur_group(g, torch.from_numpy(W), torch.from_numpy(G)).numpy()
    assert np.allclose(Hdd.hi.numpy(), Hf, rtol=1e-12, atol=1e-12)


def test_schur_group_dd_rank1_vs_f64():
    A, C, b = _mk(rank1=True)
    _, pt = _pair([A], [C], b, datarank=-1, storage="dense")
    g = pt.groups[0]
    assert g.is_rank1
    W = _spd(g.m, 6)
    G = np.linalg.cholesky(W)
    Hdd = ts.schur_group_dd(g, torch.from_numpy(W), torch.from_numpy(G))
    Hf = ts.schur_group(g, torch.from_numpy(W), torch.from_numpy(G)).numpy()
    assert np.allclose(Hdd.hi.numpy() + Hdd.lo.numpy(), Hf, rtol=1e-10)


def test_aadj_dd_sparse_vs_exact():
    n, m = 12, 10
    A = _sparse_data(n, m, seed=8)
    _, pt = _pair([A], [np.eye(m) * m], np.zeros(n), storage="sparse", pad_multiple=1)
    g = pt.groups[0]
    assert g.is_sparse
    y_hi = rng.standard_normal(n)
    y_lo = rng.standard_normal(n) * 1e-18
    got = ts.Aadj_dd(g, DD(torch.from_numpy(y_hi), torch.from_numpy(y_lo)))
    for a in range(m):
        for c in range(m):
            exact = sum((_frac(A[j, a, c]) * (_frac(y_hi[j]) + _frac(y_lo[j])) for j in range(n)),
                        Fraction(0))
            err = abs(_frac(got.hi[0, a, c]) + _frac(got.lo[0, a, c]) - exact)
            assert err <= abs(exact) * Fraction(1, 10**25) + Fraction(1, 10**28)
    f64 = ts.Aadj(g, torch.from_numpy(y_hi)).numpy()
    assert np.allclose(got.hi.numpy(), f64, rtol=1e-12, atol=1e-12)


def test_aadj_dd_rank1_vs_exact():
    A, C, b = _mk(n=8, m=6, rank1=True, seed=9)
    _, pt = _pair([A], [C], b, datarank=-1, storage="dense")
    g = pt.groups[0]
    assert g.is_rank1
    y_hi = rng.standard_normal(8)
    y_lo = rng.standard_normal(8) * 1e-18
    got = ts.Aadj_dd(g, DD(torch.from_numpy(y_hi), torch.from_numpy(y_lo)))
    B, S = g.B.numpy(), g.Bsgn.numpy()
    for a, c in [(0, 0), (1, 4), (5, 2)]:
        exact = sum((_frac(S[0, j]) * (_frac(y_hi[j]) + _frac(y_lo[j]))
                     * _frac(B[0, j, a]) * _frac(B[0, j, c]) for j in range(8)), Fraction(0))
        err = abs(_frac(got.hi[0, a, c]) + _frac(got.lo[0, a, c]) - exact)
        assert err <= abs(exact) * Fraction(1, 10**25) + Fraction(1, 10**28)


def test_schur_sparse_dd_vs_exact():
    n, m = 14, 8
    A = _sparse_data(n, m, seed=10, entries=1, rows=m)
    _, pt = _pair([A], [np.eye(m) * m], np.zeros(n), storage="sparse", pad_multiple=1)
    g = pt.groups[0]
    W = _spd(m, 11, shift=m)
    Hdd = ts._schur_sparse_dd(g, torch.from_numpy(W))
    for j, k in [(0, 0), (3, 7), (9, 2)]:
        exact = Fraction(0)
        for a in range(m):
            for c in range(m):
                if A[j, a, c] == 0:
                    continue
                wak = sum((_frac(W[0, a, t]) * _frac(A[k, t, u]) * _frac(W[0, u, c])
                           for t in range(m) for u in range(m) if A[k, t, u] != 0), Fraction(0))
                exact += _frac(A[j, a, c]) * wak
        got = _frac(Hdd.hi[j, k]) + _frac(Hdd.lo[j, k])
        assert abs(got - exact) <= abs(exact) * Fraction(1, 10**25) + Fraction(1, 10**28)
    He = ts._schur_sparse(g, torch.from_numpy(W)).numpy()
    assert np.allclose(Hdd.hi.numpy(), He, rtol=1e-12, atol=1e-12)


def test_schur_lp_dd_vs_exact():
    r = np.random.default_rng(12)
    C_lin = r.standard_normal((5, 9))
    wh = r.uniform(0.1, 10.0, 9)
    wl = wh * 1e-17 * r.standard_normal(9)
    H = ts.schur_lp_dd(torch.from_numpy(C_lin), DD(torch.from_numpy(wh), torch.from_numpy(wl)))
    for j, k in [(0, 0), (1, 3), (4, 2)]:
        exact = sum((_frac(C_lin[j, t]) * (_frac(wh[t]) + _frac(wl[t])) * _frac(C_lin[k, t])
                     for t in range(9)), Fraction(0))
        got = _frac(H.hi[j, k]) + _frac(H.lo[j, k])
        assert abs(got - exact) <= abs(exact) * Fraction(1, 10**25) + Fraction(1, 10**28)


# ---- the same inputs through the JAX package, per storage


def _storage_case(storage):
    n, m = 10, 8
    if storage == "sparse":
        A, C, b = _sparse_data(n, m, seed=13), np.eye(m) * m, rng.standard_normal(n)
        pj, pt = _pair([A, A[:, ::-1, ::-1].copy()], [C, C], b, storage="sparse", pad_multiple=1)
        pj = ensure_dd_aadj(pj)
    elif storage == "rank1":
        A, C, b = _mk(n=n, m=m, rank1=True, seed=14)
        pj, pt = _pair([A, A], [C, C], b, datarank=-1, storage="dense")
    else:
        A, C, b = _mk(n=n, m=m, seed=15)
        pj, pt = _pair([A, 0.5 * A], [C, C], b, storage="dense")
    assert len(pt.groups) == 1 and pt.groups[0].nb == 2
    return pj.groups[0], pt.groups[0]


@pytest.mark.parametrize("storage", ["dense", "rank1", "sparse"])
def test_dd_operators_match_jax(storage):
    gj, gt = _storage_case(storage)
    m, nb, n = gt.m, gt.nb, 10
    r = np.random.default_rng(16)
    W = np.concatenate([_spd(m, 17), _spd(m, 18)])
    G = np.linalg.cholesky(W)
    M = r.standard_normal((nb, m, m))
    Mlo = M * 1e-17 * r.standard_normal((nb, m, m))
    yh, yl = r.standard_normal(n), r.standard_normal(n) * 1e-17
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    j = jnp.asarray
    # rank-1 Aop_dd takes the f64 product B M first (`schur.py:466`), so the
    # two packages' GEMM orders show at f64 rounding there
    rel = 1e-14 if storage == "rank1" else 1e-28
    assert _close(ts.Aop_dd(gt, t(M), t(Mlo)), js.Aop_dd(gj, j(M), j(Mlo)), rel)
    assert _close(ts.Aadj_dd(gt, DD(t(yh), t(yl))), js.Aadj_dd(gj, JDD(j(yh), j(yl))))
    # sparse: schur_group_dd is _schur_sparse_dd in both packages
    assert _close(ts.schur_group_dd(gt, t(W), t(G)), js.schur_group_dd(gj, j(W), j(G)), 1e-27)


def test_schur_lp_dd_matches_jax():
    r = np.random.default_rng(19)
    C_lin = r.standard_normal((7, 12))
    wh = r.uniform(0.1, 10.0, 12)
    wl = wh * 1e-17 * r.standard_normal(12)
    got = ts.schur_lp_dd(torch.from_numpy(C_lin), DD(torch.from_numpy(wh), torch.from_numpy(wl)))
    ref = js.schur_lp_dd(jnp.asarray(C_lin), JDD(jnp.asarray(wh), jnp.asarray(wl)))
    assert _close(got, ref)
