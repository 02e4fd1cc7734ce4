"""tests/test_int8gemm.py on loraine_tpu_torch (`ops/int8gemm.py`, the plain
version on CPU tensors), case for case, and the port against the JAX
package on the same seeded numpy inputs.

Every operation of the scheme is exact except the sum over t, taken in the
same order in both packages, so the port equals the JAX function bit for
bit wherever both compute the same fiber exponents (`ozaki.ceil_log2`
differs only at exact powers of two, which these inputs do not hit; the
test asserts the exponents agree). The rank-1 Schur contribution under
gemm_backend='int8' is held against the JAX one the same way; the (1, 2)
mesh case is in tests/test_torch_parallel.py, the kernels' case on a card
in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loraine_tpu.io.sdpa import SDPAData as JaxSDPAData
from loraine_tpu.ops import int8gemm as jint8
from loraine_tpu.ops.schur import schur_group as jschur_group
from loraine_tpu.problem import problem_from_sdpa as jax_problem_from_sdpa
import loraine_tpu_torch as ltt
from loraine_tpu_torch.ops import int8gemm as tint8
from loraine_tpu_torch.ops.int8gemm import matmul_f64_mxu
from loraine_tpu_torch.ops.schur import schur_group
from torch_cases import maxcut_sdpa


def _mm(A, B):
    return matmul_f64_mxu(torch.from_numpy(np.asarray(A)), torch.from_numpy(np.asarray(B))).numpy()


def _err(approx, A, B):
    """Componentwise error vs a longdouble reference, normalized by the
    magnitude-sum bound |A| |B| (the natural scale for GEMM rounding)."""
    ref = np.asarray(A, np.longdouble) @ np.asarray(B, np.longdouble)
    scale = np.abs(A) @ np.abs(B) + 1e-300
    return float(np.max(np.abs((np.asarray(approx, np.longdouble) - ref) / scale)))


SHAPES = [(17, 23, 9), (64, 64, 64), (128, 40, 96)]


@pytest.mark.parametrize("shape", SHAPES)
def test_random_matches_longdouble(shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    A = rng.standard_normal((m, k))
    B = rng.standard_normal((k, n))
    e_int8 = _err(_mm(A, B), A, B)
    e_f64 = _err(A @ B, A, B)
    assert e_int8 <= max(2 * e_f64, 2 ** -52), (e_int8, e_f64)


def test_graded_rows_and_columns():
    # per-row/column exponent alignment must survive 1e+/-100 grading
    rng = np.random.default_rng(0)
    A = rng.standard_normal((32, 48)) * np.logspace(-100, 100, 32)[:, None]
    B = rng.standard_normal((48, 16)) * np.logspace(80, -80, 16)[None, :]
    assert _err(_mm(A, B), A, B) <= 2 ** -50


def test_batched():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((3, 20, 30))
    B = rng.standard_normal((3, 30, 10))
    out = _mm(A, B)
    for i in range(3):
        assert _err(out[i], A[i], B[i]) <= 2 ** -50


def test_zeros_and_signs():
    A = np.array([[0.0, -1.5, 0.0], [2.0**-500, 0.0, -(2.0**300)]])
    B = np.array([[1.0, -2.0], [0.5, 0.0], [-1.0, 4.0]])
    np.testing.assert_allclose(_mm(A, B), A @ B, rtol=1e-14, atol=1e-290)


def test_cancellation_beats_f64():
    # adversarial cancellation: sum of large +/- pairs with a tiny residual;
    # the exact integer partials recover it (f64 loses it at k = 2^14)
    k = 1 << 14
    rng = np.random.default_rng(2)
    big = rng.standard_normal(k // 2) * 1e8
    A = np.concatenate([big, -big])[None, :]  # exact cancellation
    A[0, -1] += 1.0  # tiny residual
    B = np.ones((k, 1))
    np.testing.assert_allclose(float(_mm(A, B)[0, 0]), 1.0, rtol=1e-6)


def test_rejects_f32():
    with pytest.raises(TypeError):
        matmul_f64_mxu(torch.ones((2, 2)), torch.ones((2, 2)))


def test_rejects_long_contraction():
    A = torch.zeros((1, tint8.K_MAX + 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="int32"):
        matmul_f64_mxu(A, A.mT)


def _cases():
    """The seeded inputs of the cases above, plus a batch of three."""
    out = []
    for m, k, n in SHAPES:
        rng = np.random.default_rng(m + k + n)
        out.append((rng.standard_normal((m, k)), rng.standard_normal((k, n))))
    rng = np.random.default_rng(0)
    out.append((rng.standard_normal((32, 48)) * np.logspace(-100, 100, 32)[:, None],
                rng.standard_normal((48, 16)) * np.logspace(80, -80, 16)[None, :]))
    rng = np.random.default_rng(1)
    out.append((rng.standard_normal((3, 20, 30)), rng.standard_normal((3, 30, 10))))
    return out


@pytest.mark.parametrize("case", range(5))
def test_plain_equals_jax_bitwise(case):
    A, B = _cases()[case]
    s = jint8._num_slices(55)
    assert s == tint8._num_slices(55) == 11
    # the fiber exponents (the slicing grids) agree ...
    jsl, ja = jint8._slice_int8(jnp.asarray(A), -1, s)
    _, jb = jint8._slice_int8(jnp.asarray(B), -2, s)
    tsl, ta = tint8._slice_int8(torch.from_numpy(A), -1, s)
    _, tb = tint8.fiber_exponents(torch.from_numpy(B), -2)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # ... and so the slices and the products, bit for bit
    np.testing.assert_array_equal(tsl.numpy(), np.asarray(jsl))
    np.testing.assert_array_equal(_mm(A, B), np.asarray(jint8.matmul_f64_mxu(jnp.asarray(A),
                                                                             jnp.asarray(B))))


def test_pair_schedule():
    # 11 slices, t = 0..11, 76 pairs: the JAX loop's (int8gemm.py:82-99)
    sched = tint8.pair_schedule(11, 55)
    assert [t for t, _ in sched] == list(range(12))
    assert sum(len(ps) for _, ps in sched) == 76
    assert sched[-1][1] == list(range(1, 11))


def test_rank1_schur_int8_matches_jax():
    """The rank-1 Schur contribution under gemm_backend='int8' on max-cut
    data (B G and (B G)(B G)^T by the integer scheme), against the JAX
    package's on the same W and G: the products are bitwise equal, and so
    is H = sum sgn sgn' P o P (sign products are exact)."""
    pj = jax_problem_from_sdpa(maxcut_sdpa(N=40, cls=JaxSDPAData), datarank=-1)
    pt = ltt.problem_from_sdpa(maxcut_sdpa(N=40), datarank=-1, device="cpu")
    gj, gt = pj.groups[0], pt.groups[0]
    assert gt.is_rank1
    rng = np.random.default_rng(7)
    Q = rng.standard_normal((gt.nb, gt.m, gt.m))
    W = Q @ Q.transpose(0, 2, 1) / gt.m + np.eye(gt.m)
    G = np.linalg.cholesky(W)
    Hj = np.asarray(jschur_group(gj, jnp.asarray(W), jnp.asarray(G), "int8"))
    Ht = schur_group(gt, torch.from_numpy(W), torch.from_numpy(G), "int8").numpy()
    np.testing.assert_array_equal(Ht, Hj)
    # and within f64 rounding of the f64 route
    H64 = schur_group(gt, torch.from_numpy(W), torch.from_numpy(G)).numpy()
    np.testing.assert_allclose(Ht, H64, rtol=0, atol=1e-13 * np.abs(H64).max())


def test_dense_group_ignores_int8():
    p = ltt.load_problem("tests/data/theta1.dat-s", device="cpu")
    g = p.groups[0]
    rng = np.random.default_rng(8)
    W = torch.from_numpy(np.eye(g.m)[None] + 0.1 * rng.standard_normal((g.nb, g.m, g.m)))
    W = (W + W.mT) / 2
    assert torch.equal(schur_group(g, W, W, "int8"), schur_group(g, W, W))


def test_routes_by_device():
    """The plain version only for CPU tensors; the kernel route raises on
    anything but CUDA tensors (it never computes on the CPU), and a device
    with neither route raises."""
    A = torch.ones((3, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tint8.matmul_f64_int8_cuda(A, A.mT)
    M = torch.empty((2, 2), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no int8 GEMM route"):
        matmul_f64_mxu(M, M)
