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
in tests/test_torch_cuda.py. The last tests model, in numpy, the order in
which csrc/int8gemm.cu's O2 sums (one int32 sum per weight t, then the
f64 sum in ascending t) and check `gemm_plan`'s work split.
"""
import ast
from pathlib import Path

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


# ---------------------------------------------------------------------------
# O2's order and work split (csrc/int8gemm.cu), modelled on the CPU
# ---------------------------------------------------------------------------


def _o2_model(Asl, Bsl, a_scale, b_scale, plan, tmax):
    """O2 as csrc/int8gemm.cu orders it, in numpy: one exact integer sum per
    weight t over all of its pairs (int64 here, asserted to fit int32 as the
    kernel holds it), the first chunk's f64 sum over its t in ascending
    order, then the epilogue's continuation over the later chunks' t, then
    the scales. Asl [s, n, k], Bsl [s, k, c] int8 (one batch element)."""
    s = Asl.shape[0]
    A64, B64 = Asl.astype(np.int64), Bsl.astype(np.int64)
    acc = {}
    for t, ps in tint8._pairs(s, tmax):
        a = sum(A64[p] @ B64[t - p] for p in ps)
        assert np.abs(a).max() < 2**31
        acc[t] = a.astype(np.int32)
    res = None
    for t in range(plan.tlo[-1]):  # chunk 0's t, then the epilogue's
        term = acc[t].astype(np.float64) * 2.0 ** (-tint8.INT8_BETA * (t + 2))
        res = term if res is None else res + term
    return res * (a_scale * b_scale)


@pytest.mark.parametrize("case", range(5))
def test_o2_order_equals_ozaki_sum_bitwise(case):
    """One int32 sum per t, then the ascending-t f64 sum, whatever the chunks:
    bit for bit the plain version's pair-by-pair f64 sums."""
    A, B = _cases()[case]
    A, B = (A[None], B[None]) if A.ndim == 2 else (A, B)
    s, tmax = 11, 11
    for b in range(A.shape[0]):
        At, Bt = torch.from_numpy(A[b]), torch.from_numpy(B[b])
        Asl, a_scale = tint8._slice_int8(At, -1, s)
        Bsl, b_scale = tint8._slice_int8(Bt, -2, s)
        want = tint8._ozaki_sum(Asl, Bsl, a_scale, b_scale, 55).numpy()
        n, c = At.shape[0], Bt.shape[1]
        for tlo in ((0, 12), (0, 8, 12), (0, 5, 7, 9, 10, 12)):
            plan = tint8.plan_for(1, n, c, s, tlo)
            got = _o2_model(Asl.numpy(), Bsl.numpy(), a_scale.numpy(), b_scale.numpy(), plan,
                            tmax)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", [32, 33, -33])
def test_o2_order_at_the_largest_slices_and_contraction(q):
    """Every slice at |q| = 32 or 33, k = K_MAX: a t's int32 sum reaches
    11 * 33^2 * 2^17 and still equals the plain version's f64 sums."""
    s, k = 11, tint8.K_MAX
    Asl = np.full((s, 2, k), q, np.int8)
    Asl[:, 1, ::2] = -q  # the second row cancels
    Bsl = np.full((s, k, 1), q, np.int8)
    a_scale, b_scale = np.array([[1.0], [2.0**-20]]), np.array([[2.0**30]])
    want = tint8._ozaki_sum(torch.from_numpy(Asl), torch.from_numpy(Bsl),
                            torch.from_numpy(a_scale), torch.from_numpy(b_scale), 55).numpy()
    plan = tint8.plan_for(1, 2, 1, s, (0, 6, 12))
    np.testing.assert_array_equal(_o2_model(Asl, Bsl, a_scale, b_scale, plan, 11), want)
    # t = 10 has 11 pairs: its sum is the largest an accumulator holds
    top = sum(Asl[p, 0].astype(np.int64) @ Bsl[10 - p, :, 0].astype(np.int64)
              for p in range(11))
    assert top == 11 * q * q * k < 2**31


def test_int32_accumulator_bound():
    """11 pairs of k <= K_MAX products of slices |q| <= Q_MAX fit int32, and
    the slices of graded and random inputs stay within Q_MAX (in fact 32)."""
    assert 11 * tint8.Q_MAX**2 * tint8.K_MAX < 2**31
    assert 16 * tint8.Q_MAX**2 * tint8.K_MAX >= 2**31  # O2 checks s Q_MAX^2 kp < 2^31
    for A, B in _cases():
        for X, axis in ((A, -1), (B, -2)):
            sl, _ = tint8._slice_int8(torch.from_numpy(X), axis, 11)
            assert int(sl.abs().max()) <= 32


def _smoke_shapes():
    """chip_smoke.py's OZAKI_SHAPES, read without importing the script."""
    tree = ast.parse((Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "OZAKI_SHAPES":
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no OZAKI_SHAPES")


@pytest.mark.parametrize("shape", _smoke_shapes())
def test_gemm_plan_covers_every_pair_once(shape):
    """The planner's units, mapped to tiles as the kernel maps its blocks,
    cover every (batch, tile, t, p) of the product exactly once; the CTAs of
    a cluster run one chunk on adjacent row tiles of one column; the chunks
    cut t = 0..tmax into ascending runs, chunk 0 first (the order of the f64
    sum), and launch longest first."""
    nb, n, k, c = shape
    s, tmax = 11, tint8.pair_schedule(11, 55)[-1][0]
    kp = (k + 15) // 16 * 16
    plan = tint8.gemm_plan(nb, n, c, kp, s, tmax, 132)
    tn, tc = -(-n // tint8.TILE), -(-c // tint8.TILE)
    assert plan.tc == tc and plan.tn == -(-tn // tint8.CLUSTER) * tint8.CLUSTER
    assert plan.tlo[0] == 0 and plan.tlo[-1] == tmax + 1
    assert all(a < b for a, b in zip(plan.tlo, plan.tlo[1:]))
    pairs = dict(tint8._pairs(s, tmax))
    weight = [sum(len(pairs[t]) for t in range(plan.tlo[i], plan.tlo[i + 1]))
              for i in range(len(plan.order))]
    units = plan.units()
    assert [weight[u[0]] for u in units] == sorted((weight[u[0]] for u in units), reverse=True)
    seen = {}
    for u0 in range(0, len(units), tint8.CLUSTER):
        cl = units[u0:u0 + tint8.CLUSTER]
        assert len({(ch, b, tj) for ch, b, _, tj in cl}) == 1
        assert [ti for _, _, ti, _ in cl] == list(range(cl[0][2], cl[0][2] + tint8.CLUSTER))
        for ch, b, ti, tj in cl:
            for t in range(plan.tlo[ch], plan.tlo[ch + 1]):
                for p in pairs[t]:
                    key = (b, ti, tj, t, p)
                    seen[key] = seen.get(key, 0) + 1
    want = {(b, ti, tj, t, p) for b in range(nb) for ti in range(plan.tn) for tj in range(tc)
            for t in range(tmax + 1) for p in pairs[t]}
    assert set(seen) == want and set(seen.values()) == {1}
    assert plan.tn - tn < tint8.CLUSTER  # padding only to whole clusters


@pytest.mark.parametrize("j", [-1000, -600, -60, -1, 0, 1, 7, 60, 600, 1000])
def test_slice_exponents_at_powers_of_two(j):
    """Fiber maxima of exactly 2^j and of the double just below: e is
    floor(log2(mx)) + 2 (j + 2 at 2^j; j + 1 or j + 2 below it, as log2
    rounds), 2^e covers 2 mx, every slice stays within 32, and the slices
    rebuild the fiber to 2^(e - 6 s)."""
    top = 2.0**j
    rng = np.random.default_rng(abs(j))
    X = rng.uniform(-1, 1, (2, 40)) * (top / 2)
    X[0, 3], X[1, 5] = top, -np.nextafter(top, 0)
    e, scale = tint8.fiber_exponents(torch.from_numpy(X), -1)
    e = e[:, 0].numpy()
    assert e[0] == j + 2 and e[1] in (j + 1, j + 2)
    assert (scale[:, 0].numpy() >= 2 * np.abs(X).max(axis=1)).all()
    sl, _ = tint8._slice_int8(torch.from_numpy(X), -1, 11)
    assert int(sl.abs().max()) <= 32
    for r in range(2):
        if e[r] - 6 * 11 < -1000:  # the rebuilt sum would leave the normal range
            continue
        rebuilt = sum(np.ldexp(sl[p, r].numpy().astype(np.float64), int(e[r]) - 6 * (p + 1))
                      for p in range(11))
        assert np.abs(rebuilt - X[r]).max() <= np.ldexp(1.0, int(e[r]) - 6 * 11)
