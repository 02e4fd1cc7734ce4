"""loraine_tpu_torch.ops.ozaki (the Ozaki-scheme accurate matmul) against
the exact rational oracle of tests/test_ozaki.py and against the JAX
package.

Every case of tests/test_ozaki.py runs on the port with the same
tolerances. On the same seeded numpy inputs the two packages' slices are
bitwise equal, and so is `acc_matmul`: each partial GEMM is exact by
construction, so neither BLAS's summation order matters, and the dd adds
run in the same order. That needs both to pick the same slice exponents;
at a fiber whose maximum is an exact power of two XLA's f64 log2 can come
out one ulp low where torch's is exact (`ceil_log2`), so there the slicings
differ by one grid step and the results agree within 2^-100 of the |A||B|
scale instead (`test_acc_matmul_power_of_two_fibers`).
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loraine_tpu.ops.ozaki as joz
from loraine_tpu_torch.ops.ozaki import (_slice_params, acc_matmul, acc_matvec, dd_gemm_hi_lo,
                                         pow2_int, slice_operand)

rng = np.random.default_rng(7)


def T(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _exact_entry(A, B, i, j):
    return sum((Fraction(float(A[i, t])) * Fraction(float(B[t, j])) for t in range(A.shape[1])),
               Fraction(0))


def _scale(A, B, i, j):
    return sum((abs(Fraction(float(A[i, t])) * Fraction(float(B[t, j])))
                for t in range(A.shape[1])), Fraction(0))


def _got(C, *idx):
    return Fraction(float(C.hi[idx])) + Fraction(float(C.lo[idx]))


def test_slices_reconstruct():
    X = rng.standard_normal((13, 17)) * np.exp(rng.uniform(-15, 15, (13, 17)))
    recon = sum(s.numpy() for s in slice_operand(T(X), -1, 21, 5))
    assert np.array_equal(recon, X)


@pytest.mark.parametrize("k", [8, 100, 700])
def test_acc_matmul_accuracy(k):
    A = rng.standard_normal((9, k)) * np.exp(rng.uniform(-8, 8, (9, k)))
    B = rng.standard_normal((k, 6)) * np.exp(rng.uniform(-8, 8, (k, 6)))
    C = acc_matmul(T(A), T(B))
    for i, j in [(0, 0), (4, 3), (8, 5)]:
        err = abs(_got(C, i, j) - _exact_entry(A, B, i, j))
        assert err <= _scale(A, B, i, j) * Fraction(1, 10**29) + Fraction(1, 10**280)


def test_acc_matmul_cancellation_beats_f64():
    n = 60
    H = np.array([[1.0 / (i + j + 1) for j in range(n)] for i in range(n)])
    Hinv_ish = np.linalg.inv(H + 1e-10 * np.eye(n))
    C = acc_matmul(T(H), T(Hinv_ish))
    exact00 = _exact_entry(H, Hinv_ish, 0, 0)
    assert abs(_got(C, 0, 0) - exact00) <= abs(exact00) * Fraction(1, 10**20)
    err_plain = abs(float(Fraction(float((H @ Hinv_ish)[0, 0])) - exact00))
    assert abs(float(_got(C, 0, 0) - exact00)) <= err_plain


def test_acc_matvec_batched():
    A = rng.standard_normal((3, 12, 20))
    x = rng.standard_normal((3, 20))
    r = acc_matvec(T(A), T(x))
    assert r.hi.shape == (3, 12)
    for b in range(3):
        exact = _exact_entry(A[b], x[b][:, None], 5, 0)
        assert abs(_got(r, b, 5) - exact) <= abs(exact) * Fraction(1, 10**26) + Fraction(1, 10**40)


def test_acc_matmul_zero_rows():
    A = np.zeros((4, 16))
    A[0] = rng.standard_normal(16)
    C = acc_matmul(T(A), T(rng.standard_normal((16, 4))))
    assert torch.isfinite(C.hi).all() and np.allclose(C.hi[1:].numpy(), 0.0)


def test_pow2_int_full_domain():
    es = np.array([0, 1, -1, 52, -52, 500, -500, 1000, -1000, 1022, -1022, 1023])
    assert np.array_equal(pow2_int(torch.as_tensor(es)).numpy(), np.array([2.0**e for e in es]))
    es2 = np.array([1024, 2000, -1023, -1074, -2000])
    assert np.array_equal(pow2_int(torch.as_tensor(es2)).numpy(),
                          np.array([2.0 ** min(max(e, -1022), 1023) for e in es2]))
    # the whole clamped domain, against the JAX package
    e = np.arange(-1100, 1101)
    assert np.array_equal(pow2_int(torch.as_tensor(e)).numpy(), np.asarray(joz.pow2_int(jnp.asarray(e))))


def test_slice_operand_tiny_fibers_in_domain():
    X = np.array([[2.0**-405, -(2.0**-420), 0.0, 2.0**-401], [1.0, 2.0, 3.0, 4.0]])
    recon = sum(s.numpy() for s in slice_operand(T(X), -1, 21, 6))
    assert np.all(np.isfinite(recon))
    assert np.allclose(recon, X, rtol=0, atol=2.0**-800)
    assert np.array_equal(recon[1], X[1])


def test_dd_gemm_hi_lo():
    A = rng.standard_normal((7, 30))
    Alo = A * 2.0**-60 * rng.standard_normal((7, 30))
    B = rng.standard_normal((30, 5))
    C = dd_gemm_hi_lo(T(A), T(Alo), T(B))
    for i, j in [(0, 0), (6, 4)]:
        exact = sum((( Fraction(float(A[i, t])) + Fraction(float(Alo[i, t]))) * Fraction(float(B[t, j]))
                     for t in range(30)), Fraction(0))
        assert abs(_got(C, i, j) - exact) <= _scale(A, B, i, j) * Fraction(1, 10**28)


# ---- the same inputs through the JAX package


@pytest.mark.parametrize("shape,axis,k", [((9, 100), -1, 100), ((100, 6), -2, 100),
                                          ((3, 40, 800), -1, 800)])
def test_slice_operand_bitwise_equal_jax(shape, axis, k):
    X = rng.standard_normal(shape) * 2.0 ** rng.integers(-300, 300, shape)
    beta, s = _slice_params(k, 106)
    assert (beta, s) == joz._slice_params(k, 106)
    for a, b in zip(slice_operand(T(X), axis, beta, s), joz.slice_operand(jnp.asarray(X), axis, beta, s)):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("k", [8, 100, 800])
def test_acc_matmul_bitwise_equal_jax(k):
    r = np.random.default_rng(k)
    A = r.standard_normal((2, 9, k)) * np.exp(r.uniform(-8, 8, (2, 9, k)))
    B = r.standard_normal((2, k, 6)) * np.exp(r.uniform(-8, 8, (2, k, 6)))
    C = acc_matmul(T(A), T(B))
    J = joz.acc_matmul(jnp.asarray(A), jnp.asarray(B))
    assert np.array_equal(C.hi.numpy(), np.asarray(J.hi))
    assert np.array_equal(C.lo.numpy(), np.asarray(J.lo))


def test_acc_matmul_power_of_two_fibers():
    """Fibers whose maximum is an exact power of two (XLA's log2 may round
    one ulp low there): within 2^-100 of the |A||B| scale of the JAX
    package's result, and of the exact product."""
    r = np.random.default_rng(11)
    k = 50
    A = r.standard_normal((6, k))
    B = r.standard_normal((k, 4))
    A[:, 0] = 2.0 ** r.integers(3, 40, 6)  # the row maxima
    B[0, :] = 2.0 ** r.integers(3, 40, 4)
    C = acc_matmul(T(A), T(B))
    J = joz.acc_matmul(jnp.asarray(A), jnp.asarray(B))
    for i in range(6):
        for j in range(4):
            tol = _scale(A, B, i, j) * Fraction(1, 2**100)
            jv = Fraction(float(J.hi[i, j])) + Fraction(float(J.lo[i, j]))
            assert abs(_got(C, i, j) - jv) <= tol
            assert abs(_got(C, i, j) - _exact_entry(A, B, i, j)) <= tol
