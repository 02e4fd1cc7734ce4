"""loraine_tpu_torch.ops.dd (double-double primitives) against the exact
rational oracle of tests/test_dd.py and against the JAX package.

Every case of tests/test_dd.py runs on the port's functions with the same
tolerances. Then the same seeded numpy inputs go through both packages:
two_sum, two_prod, dd_add, dd_sum, dd_dot and dd_mul_f64 must agree bit for
bit (the same IEEE operations, each rounded once, in the same order).
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loraine_tpu.ops.dd as jdd
from loraine_tpu_torch.ops.dd import (DD, dd_add, dd_dot, dd_matvec, dd_mul_f64, dd_neg,
                                      dd_sum, dd_to_f64, two_prod, two_sum)

rng = np.random.default_rng(0)


def T(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _exact_dot(a, b):
    return sum((Fraction(float(x)) * Fraction(float(y)) for x, y in zip(a, b)), Fraction(0))


def _dd_frac(d, idx=()):
    return Fraction(float(d.hi[idx])) + Fraction(float(d.lo[idx]))


def test_two_sum_exact():
    a = T([1.0, 1e16, 1.0, -1e-30])
    b = T([2.0**-60, 1.0, -1.0, 1e-30])
    s = two_sum(a, b)
    for i in range(4):
        assert _dd_frac(s, (i,)) == Fraction(float(a[i])) + Fraction(float(b[i]))


def test_two_prod_exact():
    r = np.random.default_rng(1)
    a = r.standard_normal(64) * np.exp(r.uniform(-20, 20, 64))
    b = r.standard_normal(64) * np.exp(r.uniform(-20, 20, 64))
    p = two_prod(T(a), T(b))
    for i in range(64):
        assert _dd_frac(p, (i,)) == Fraction(float(a[i])) * Fraction(float(b[i]))


def test_dd_sum_cancellation():
    x = T([1.0, 2.0**-53, -1.0, 2.0**-80])
    s = dd_sum(DD(x, torch.zeros_like(x)))
    exact = Fraction(2) ** -53 + Fraction(2) ** -80
    assert abs(_dd_frac(s) - exact) <= exact * Fraction(1, 10**20)


@pytest.mark.parametrize("n", [3, 64, 1000])
def test_dd_dot_ill_conditioned(n):
    r = np.random.default_rng(42 + n)
    v = r.standard_normal(n) * 1e8
    a = np.concatenate([v, -v, [1.0]])
    b = np.concatenate([np.ones(n), np.ones(n), [1e-12]])
    perm = r.permutation(a.size)
    a, b = a[perm], b[perm]
    d = dd_dot(T(a), T(b))
    exact = _exact_dot(a, b)
    err = abs(_dd_frac(d) - exact)
    assert err <= Fraction(1, 10**22)
    assert abs(Fraction(float(np.dot(a, b))) - exact) >= err


def test_dd_dot_batched_shape_and_accuracy():
    r = np.random.default_rng(2)
    a, b = r.standard_normal((5, 7, 33)), r.standard_normal((5, 7, 33))
    d = dd_dot(T(a), T(b))
    assert d.hi.shape == (5, 7)
    for i, j in [(0, 0), (2, 3), (4, 6)]:
        exact = _exact_dot(a[i, j], b[i, j])
        assert abs(_dd_frac(d, (i, j)) - exact) <= abs(exact) * Fraction(1, 10**28) + Fraction(1, 10**30)


def test_dd_matvec_accuracy():
    r = np.random.default_rng(3)
    H = r.standard_normal((40, 40))
    H = H @ H.T + 1e-12 * np.eye(40)
    x = r.standard_normal(40)
    d = dd_matvec(T(H), T(x))
    for row in [0, 17, 39]:
        exact = _exact_dot(H[row], x)
        assert abs(_dd_frac(d, (row,)) - exact) <= abs(exact) * Fraction(1, 10**28) + Fraction(1, 10**30)


def test_dd_add_running_accumulation():
    r = np.random.default_rng(4)
    xs = r.standard_normal(100) * np.exp(r.uniform(-30, 30, 100))
    acc = DD(T(0.0), T(0.0))
    for v in xs:
        acc = dd_add(acc, DD(T(float(v)), T(0.0)))
    exact = sum((Fraction(float(v)) for v in xs), Fraction(0))
    assert abs(_dd_frac(acc) - exact) <= abs(exact) * Fraction(1, 10**25)
    assert np.isclose(float(dd_to_f64(acc)), float(exact))
    assert torch.equal(dd_neg(dd_neg(acc)).hi, acc.hi)


def test_dd_requires_f64():
    """The option surface of tests/test_dd.py:120-132 on the port: dd needs
    float64, runs on both paths, and unknown tiers are rejected."""
    import loraine_tpu_torch as ltt

    with pytest.raises(ValueError):
        ltt.Options(precision="dd", dtype="float32").validated()
    assert ltt.Options(precision="dd", kit=1).validated().kit == 1
    with pytest.raises(ValueError):
        ltt.Options(precision="qd").validated()


# ---- the same inputs through the JAX package: bit for bit


def _adversarial(seed, shape):
    """Normals scaled by 2^[-300, 300] with exact cancellations mixed in."""
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape) * 2.0 ** r.integers(-300, 300, shape)
    flat = x.reshape(-1)
    flat[1::7] = -flat[::7][: flat[1::7].size]
    return x


def _same(t: DD, j) -> bool:
    return all(np.array_equal(a.numpy(), np.asarray(b), equal_nan=True)
               for a, b in zip(t, j))


@pytest.mark.parametrize("seed", [0, 1])
def test_eft_bitwise_equal_jax(seed):
    a, b = _adversarial(seed, (4, 257)), _adversarial(seed + 10, (4, 257))
    ta, tb = T(a), T(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert _same(two_sum(ta, tb), jdd.two_sum(ja, jb))
    # products within f64's range: the exponents stay inside +-600
    assert _same(two_prod(ta, tb), jdd.two_prod(ja, jb))
    x, y = DD(ta, tb * 2.0**-60), DD(tb, ta * 2.0**-60)
    jx, jy = jdd.DD(ja, jb * 2.0**-60), jdd.DD(jb, ja * 2.0**-60)
    assert _same(dd_add(x, y), jdd.dd_add(jx, jy))
    assert _same(dd_mul_f64(x, tb), jdd.dd_mul_f64(jx, jb))
    for axis in (0, -1):
        assert _same(dd_sum(x, axis), jdd.dd_sum(jx, axis))
    assert _same(dd_dot(ta, tb), jdd.dd_dot(ja, jb))
