"""The CUDA kernels of loraine_tpu_torch (ops/jacobi.py, ops/pcg.py,
ops/int8gemm.py, ops/dd_linalg.py) on a card.

Needs an NVIDIA GPU (marker `cuda`; skips without one). This file imports
neither jax nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from loraine_tpu_torch.ops import int8gemm as ti, jacobi as tj, pcg as tp
from torch_cases import spectrum_matrix


# the regimes of each kernel (B1, B2) by shape: (dsmem, dsmem) at theta1's
# m, two of them, (1, 176), (1, 240) and (4, 144); (cluster, cluster) at
# maxG11's; (grid, grid) at the 1000-node torus's; (sm, sm) at tru3's and
# past one wave of "dsmem" clusters; then (grid, grid) at the 2000-node
# torus's size (B1's eigenvector rows in global memory) and with two
# matrices sharing the card, and (rounds, rounds) past the grid's capacity
# on an H100 SXM, one sweep each (None: the sweep schedule)
@pytest.mark.cuda
@pytest.mark.parametrize("nb,m,sweeps", [(1, 56, None), (2, 56, None), (1, 800, None),
                                         (1, 176, None), (1, 240, None), (1, 1000, None),
                                         (4, 144, None), (1, 13, None), (8, 144, None),
                                         (1, 2000, 1), (2, 1000, 1), (1, 2416, 1)])
def test_kernels_match_plain_on_card(nb, m, sweeps):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    A = torch.from_numpy(spectrum_matrix("clustered", m, nb, seed=m)).cuda()
    Mn, scale = tj._normalize_pad(A)
    mp = Mn.shape[-1]
    s1, s2 = sweeps or tj.jacobi_sweeps_for(m), sweeps or tj.bound_sweeps_for(m)
    kernels = ((tj.jacobi_eigh_cuda, True), (tj.jacobi_bounds_cuda, False))
    before = [fn.launches_by_regime.copy() for fn, _ in kernels]
    out_k = tj.jacobi_eigh_cuda(Mn, s1)
    g_h = tj.jacobi_bounds_cuda(Mn, s2)
    sms = tj.sm_count(Mn.device)
    for (fn, eigvecs), old in zip(kernels, before):  # one launch, in the shape's regime
        assert fn.launches_by_regime - old == {tj.regime_for(nb, mp, eigvecs, sms): 1}
    out_p = tj.jacobi_eigh_plain(Mn, s1)
    torch.cuda.synchronize()
    # every regime rounds each operation once, in the plain version's order
    # (csrc/jacobi.cu): B1 equals the plain version's tensor ops bit for bit
    assert all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    if tj.regime_for(nb, mp, False, sms) == "grid":  # B2: bit for bit the regime it replaced
        g_r, h_r = torch.empty_like(g_h[0]), torch.empty_like(g_h[1])
        tj._run(False, Mn, (g_r, h_r), s2, "rounds")
        assert torch.equal(g_h[0], g_r) and torch.equal(g_h[1], h_r)
    # the contracts of tests/test_jacobi_pallas.py on the sorted seed and the
    # certified bounds (B2's row sums add in another order than torch's)
    lo_k, hi_k = tj._widened_bounds(*g_h, m, scale, A.dtype)
    lo_p, hi_p = tj._widened_bounds(*tj.jacobi_bounds_plain(Mn, s2), m, scale, A.dtype)
    ev = torch.linalg.eigvalsh(A)
    for lo, hi in ((lo_k, hi_k), (lo_p, hi_p)):  # Gershgorin: valid after any sweeps
        assert (lo <= ev[:, 0]).all() and (hi >= ev[:, -1]).all()
    if sweeps is not None:  # one sweep: bit equality and valid bounds, not a converged seed
        return
    lam_k, V = tj._sorted_eigh(*out_k, m, scale)
    lam_p, _ = tj._sorted_eigh(*out_p, m, scale)
    sc = scale[:, None]
    assert ((lam_k.double() - lam_p.double()).abs() / sc).max() < 5e-5
    assert ((lam_k.double() - ev).abs() / sc).max() < 5e-5
    Vd = V.double()
    R = (Vd * lam_k.double()[:, None, :]) @ Vd.mT
    assert ((R - A).abs().amax((-1, -2)) / scale).max() < 1e-4
    # m >= 256 runs the trimmed schedule (10 sweeps): seed orthogonality is
    # then ~2.5e-4 for the plain version too (chip_smoke.py compares them)
    assert (Vd.mT @ Vd - torch.eye(m, dtype=Vd.dtype, device=Vd.device)).abs().max() < (
        1e-4 if m < 256 else 1e-3)
    # the net of chip_smoke.py: per instance the slack is rounding luck on
    # clustered spectra (60 seeds at m=56: medians 1.50e-4 kernel, 1.43e-4
    # plain); fail only a kernel looser than twice the plain bound and 1e-3
    slack_k = (torch.maximum(ev[:, 0] - lo_k, hi_k - ev[:, -1]) / scale).max()
    slack_p = (torch.maximum(ev[:, 0] - lo_p, hi_p - ev[:, -1]) / scale).max()
    assert slack_k < max(1e-3, 2 * float(slack_p))


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3])
def test_dsmem_equals_plain_and_replaced_regime_on_card(nb):
    """B1 and B2 at tru9's padded size (m 145, mp 160) take "dsmem", one
    launch each under its name; B1's (lam, VT) equal the plain version's bit
    for bit, and both kernels' outputs equal those of "sm", "cluster" (the
    regimes "dsmem" replaced there) and "rounds" (B2's row sums add in
    another order than the plain version's, so B2 is held to the other
    regimes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    m = 145
    A = torch.from_numpy(spectrum_matrix("clustered", m, nb, seed=nb)).cuda()
    Mn, _ = tj._normalize_pad(A)
    mp = Mn.shape[-1]
    sms = tj.sm_count(Mn.device)
    s1, s2 = tj.jacobi_sweeps_for(m), tj.bound_sweeps_for(m)
    assert mp == 160 and tj.regime_for(nb, mp, True, sms) == tj.regime_for(nb, mp, False, sms) == "dsmem"
    before = [fn.launches_by_regime.copy() for fn in (tj.jacobi_eigh_cuda, tj.jacobi_bounds_cuda)]
    lam, vt = tj.jacobi_eigh_cuda(Mn, s1)
    g, h = tj.jacobi_bounds_cuda(Mn, s2)
    after = [fn.launches_by_regime for fn in (tj.jacobi_eigh_cuda, tj.jacobi_bounds_cuda)]
    assert [a - b for a, b in zip(after, before)] == [{"dsmem": 1}, {"dsmem": 1}]
    lam_p, vt_p = tj.jacobi_eigh_plain(Mn, s1)
    assert torch.equal(lam, lam_p) and torch.equal(vt, vt_p)
    for regime in ("sm", "cluster", "rounds"):  # each fits both kernels at mp 160
        vt_o, lam_o, g_o, h_o = (torch.empty_like(t) for t in (vt, lam, g, h))
        tj._run(True, Mn, (vt_o, lam_o), s1, regime)
        tj._run(False, Mn, (g_o, h_o), s2, regime)
        assert all(torch.equal(a, b) for a, b in zip((lam, vt, g, h), (lam_o, vt_o, g_o, h_o)))


def _cg_case(n):
    """kappa 1e3, identity preconditioner (tests/test_pcg_pallas.py:26-41)."""
    rng = np.random.default_rng(n)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    H = (Q * np.logspace(0, -3, n)) @ Q.T
    H = torch.from_numpy((H + H.T) / 2).cuda()
    return H, torch.from_numpy(rng.standard_normal(n)).cuda()


# one n per regime of the CG kernels, in f64 and in f32: "block", "cluster",
# "grid"
CG_SIZES = [21, 464, 1000]


def _one_launch(fn, n, dtype):
    """(counter snapshot, the regime the shape rule picks)."""
    return fn.launches_by_regime.copy(), tp.regime_for_cg(n, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n", CG_SIZES)
def test_b3_matches_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    H, b = _cg_case(n)
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    before, regime = _one_launch(tp.cg_minres_f64_cuda, n, torch.float64)
    xk, ik = tp.pcg_kernel_ff(H, eye, b, 1e-10, 10000)  # routed: the kernel
    # two refinement passes, each one launch in the shape's regime
    assert tp.cg_minres_f64_cuda.launches_by_regime - before == {regime: 2}
    xp, ip = tp.pcg_kernel_ff(H, eye, b, 1e-10, 10000, body=tp.cg_minres_plain)
    torch.cuda.synchronize()
    # same f64 algorithm, other summation order (chip_smoke.py phase 6)
    for x in (xk, xp):
        assert torch.linalg.norm(b - H @ x) <= 1e-10 * torch.linalg.norm(b)
    assert (xk - xp).abs().max() <= 1e3 * 1e-10 * 10 * xp.abs().max()
    assert abs(int(ik) - int(ip)) <= 0.1 * int(ip) + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", CG_SIZES)
def test_b4_matches_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    H, b = _cg_case(n)
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    before, regime = _one_launch(tp.cg_f32_cuda, n, torch.float32)
    xk, ik = tp.pcg_kernel_mixed(H, eye, b, 1e-10, 10000)  # routed: the kernel
    assert tp.cg_f32_cuda.launches_by_regime - before == {regime: 3}  # three passes
    xp, ip = tp.pcg_kernel_mixed(H, eye, b, 1e-10, 10000, body=tp.cg_f32_plain)
    torch.cuda.synchronize()
    for x in (xk, xp):
        assert torch.linalg.norm(b - H @ x) <= 1e-10 * torch.linalg.norm(b)
    assert (xk - xp).abs().max() <= 1e3 * 1e-10 * 10 * xp.abs().max()
    assert abs(int(ik) - int(ip)) <= 0.1 * int(ip) + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", CG_SIZES)
def test_polish_kernel_matches_cg_plain_on_card(n):
    """The kit=1 route's polish (`ipm/step.py::_polish`) on a CUDA tensor is
    one launch of the f64 kernel; `ops.cg.cg_plain` runs the same CG with
    the same stopping rule, one host read an iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from loraine_tpu_torch.ipm.step import _polish
    from loraine_tpu_torch.ops.cg import cg_plain

    H, b = _cg_case(n)
    tol = 1e-10
    target = tol * torch.linalg.norm(b)
    before, regime = _one_launch(tp.cg_f64_cuda, n, torch.float64)
    xk, ik = _polish(H, b, target, 10000)
    assert tp.cg_f64_cuda.launches_by_regime - before == {regime: 1}
    xp, ip = cg_plain(lambda v: H @ v, b, tol, 10000)
    torch.cuda.synchronize()
    for x in (xk, xp):
        assert torch.linalg.norm(b - H @ x) <= tol * torch.linalg.norm(b)
    assert (xk - xp).abs().max() <= 1e3 * tol * 10 * xp.abs().max()
    assert abs(int(ik) - int(ip)) <= 0.1 * int(ip) + 2


@pytest.mark.cuda
def test_kernel_route_never_reads_the_host_per_cg_iteration(monkeypatch):
    """theta1 on the materialized CG route on the card: B3 and the polish
    kernel, never the eager `cg_plain` loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import loraine_tpu_torch as ltt
    import loraine_tpu_torch.ipm.step as S

    eager = S.cg_plain

    def cpu_only(matvec, b, tol, maxiter):
        if b.device.type == "cuda":
            raise AssertionError("cg_plain called on a CUDA tensor")
        return eager(matvec, b, tol, maxiter)

    monkeypatch.setattr(S, "cg_plain", cpu_only)
    before = tp.cg_f64_cuda.launches
    r = ltt.solve_sdpa("tests/data/theta1.dat-s",
                       {"kit": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-5, "preconditioner": 1,
                        "initpoint": 1, "verb": 0}, device="cuda")
    assert r.status_name == "OPTIMAL" and abs(r.objective - 23.0) <= 1e-5 * 23.0
    assert tp.cg_f64_cuda.launches - before == 2 * r.iterations  # predictor, corrector


@pytest.mark.cuda
def test_sparse_contractions_reproducible_on_card():
    """The sparse adjoint (per-cell layout, no float atomics) and the sparse
    Schur assembly: bitwise equal from call to call on the card, and equal
    to the CPU's result to rounding (forced-sparse tru3, LP cone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import loraine_tpu_torch as ltt
    from loraine_tpu_torch.ops import schur as ts

    outs = {}
    for dev in ("cpu", "cuda"):
        p = ltt.load_problem("tests/data/tru3.dat-s", {"datasparsity": 64}, device=dev)
        (g,) = p.groups
        rng = np.random.default_rng(3)
        R = torch.from_numpy(rng.standard_normal((g.nb, g.m, g.m))).to(dev)
        W = R @ R.mT + g.m * torch.eye(g.m, dtype=R.dtype, device=dev)
        y = torch.from_numpy(rng.standard_normal(p.n)).to(dev)
        runs = [(ts.Aadj(g, y), ts.schur_group(g, W, None)) for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)
        outs[dev] = [x.cpu().numpy() for x in runs[0]]
    for c, k in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_allclose(k, c, rtol=1e-12, atol=1e-12 * np.abs(c).max())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [800, 2500])
def test_dd_arithmetic_card_equals_cpu(k):
    """The precision tiers' arithmetic (ops/dd.py, ops/ozaki.py) rounds each
    operation once on the card too: two_sum, two_prod, dd_add, dd_sum and
    acc_matmul (its partial GEMMs exact under cuBLAS f64) equal the CPU's
    results bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: compares the card's arithmetic with the CPU's")
    from loraine_tpu_torch.ops import dd as D, ozaki as Z

    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((8, k)) * 2.0 ** rng.integers(-300, 300, (8, k)))
    b = torch.from_numpy(rng.standard_normal((8, k)) * 2.0 ** rng.integers(-300, 300, (8, k)))
    b[:, ::2] = -a[:, ::2]
    x, y = D.DD(a, b * 2.0**-60), D.DD(b, a * 2.0**-60)
    on = lambda t: D.DD(t.hi.cuda(), t.lo.cuda())  # noqa: E731
    for card, cpu in ((D.two_sum(a.cuda(), b.cuda()), D.two_sum(a, b)),
                      (D.two_prod(a.cuda(), b.cuda()), D.two_prod(a, b)),
                      (D.dd_add(on(x), on(y)), D.dd_add(x, y)),
                      (D.dd_sum(on(x)), D.dd_sum(x))):
        assert all(torch.equal(u.cpu(), v) for u, v in zip(card, cpu))
    A = torch.from_numpy(rng.standard_normal((64, k)) * np.exp(rng.uniform(-8, 8, (64, k))))
    B = torch.from_numpy(rng.standard_normal((k, 48)) * np.exp(rng.uniform(-8, 8, (k, 48))))
    card = Z.acc_matmul(A.cuda(), B.cuda())
    assert all(torch.equal(u.cpu(), v) for u, v in zip(card, Z.acc_matmul(A, B)))


# (batch, n, k, c): odd shapes, a batch, maxG11's 800^3 and thetaG11's
# [2401, 801] @ [801, 801] and [2401, 801] @ [801, 2401]
@pytest.mark.cuda
@pytest.mark.parametrize("nb,n,k,c", [(1, 17, 23, 9), (2, 128, 40, 96), (1, 800, 800, 800),
                                      (1, 2401, 801, 801), (1, 2401, 801, 2401)])
def test_ozaki_kernels_match_plain_on_card(nb, n, k, c):
    """O1 and O2 (csrc/int8gemm.cu) against their plain versions on the same
    inputs on the card: O1's exponents use the log2 torch's does, every
    operation but the sum over t is exact and that sum runs in the plain
    version's order, so the slices, exponents, scales and products are bit
    for bit, whichever split of the weights O2 runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    rng = np.random.default_rng(n + k + c)
    A = torch.from_numpy(rng.standard_normal((nb, n, k))).cuda()
    B = torch.from_numpy(rng.standard_normal((nb, k, c)) * np.logspace(-30, 30, c)).cuda()
    _check_ozaki_on_card(A, B)


@pytest.mark.cuda
def test_ozaki_exponents_at_powers_of_two_on_card():
    """Fibers whose maxima are exactly 2^j or the double just below: O1's
    exponents, scales and slices equal the plain version's there too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    rng = np.random.default_rng(12)
    n, k, c = 96, 200, 80
    A = rng.uniform(-1, 1, (1, n, k))
    B = rng.uniform(-1, 1, (1, k, c))
    js = rng.integers(-60, 60, max(n, c))
    for i in range(n):
        top = 2.0 ** js[i]
        A[0, i] *= top / 2
        A[0, i, i % k] = top if i % 2 else np.nextafter(top, 0)
    for j in range(c):
        top = 2.0 ** js[j]
        B[0, :, j] *= top / 2
        B[0, j % k, j] = -top if j % 2 else -np.nextafter(top, 0)
    _check_ozaki_on_card(torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda())


def _check_ozaki_on_card(A, B):
    nb, n, k = A.shape
    c = B.shape[-1]
    s, tmax = 11, ti.pair_schedule(11, 55)[-1][0]
    before = (ti.ozaki_slice_s8_cuda.launches, ti.ozaki_gemm_s8_cuda.launches)
    Asl, ea, sa = ti.ozaki_slice_s8_cuda(A, s)
    Bsl, eb, sb = ti.ozaki_slice_s8_cuda(B.mT, s)
    out = ti.ozaki_gemm_s8_cuda(Asl, Bsl, sa, sb, tmax)
    # the planner's split and a single chunk (no epilogue)
    one = ti.plan_for(nb, n, c, s, (0, tmax + 1))
    out1 = ti.ozaki_gemm_s8_cuda(Asl, Bsl, sa, sb, tmax, plan=one)
    assert (ti.ozaki_slice_s8_cuda.launches, ti.ozaki_gemm_s8_cuda.launches) == (
        before[0] + 2, before[1] + 2)
    for X, sl, e, sc in ((A, Asl, ea, sa), (B.mT, Bsl, eb, sb)):
        psl, pe, psc = ti.slice_plain(X, s)
        torch.cuda.synchronize()
        assert torch.equal(e, pe) and torch.equal(sc, psc)
        assert torch.equal(sl, psl)
    pa, _ = ti._slice_int8(A, -1, s)
    pb, _ = ti._slice_int8(B, -2, s)
    P = ti._ozaki_sum(pa, pb, sa[..., None], sb[:, None], 55)
    assert torch.equal(out, P) and torch.equal(out1, P)
    # a whole product: O1 twice and O2 once
    before = (ti.ozaki_slice_s8_cuda.launches, ti.ozaki_gemm_s8_cuda.launches)
    whole = ti.matmul_f64_mxu(A, B)
    assert (ti.ozaki_slice_s8_cuda.launches, ti.ozaki_gemm_s8_cuda.launches) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(whole, ti.matmul_f64_int8_plain(A, B))


def _dd_on_card(x, rng):
    """A dd matrix on the card: hi = x, lo ~ 1e-17 of it."""
    from loraine_tpu_torch.ops.dd import DD

    x = torch.from_numpy(x)
    return DD(x.cuda(), (x * 1e-17 * torch.from_numpy(rng.standard_normal(x.shape))).cuda())


# D1-D3 (csrc/dd_linalg.cu) at nt_scale_dd's shapes (theta1's m = 56, a
# batch of two) and on each side of each regime boundary on an H100: D1
# "block" to m 20, "cluster" of 8 from m 22 to 192 and of 16 from 194 to 264,
# "global" from 266; D2 "warp" to m 105, "global" from 106 (with the regime
# each kernel takes at m)
DD_CARD_SHAPES = [(1, 8, "block", "warp"), (2, 8, "block", "warp"), (1, 20, "block", "warp"),
                  (1, 22, "cluster", "warp"), (1, 56, "cluster", "warp"),
                  (2, 56, "cluster", "warp"), (2, 96, "cluster", "warp"),
                  (1, 104, "cluster", "warp"), (1, 106, "cluster", "global"),
                  (1, 192, "cluster", "global"), (1, 194, "cluster", "global"),
                  (1, 264, "cluster", "global"), (1, 266, "global", "global")]


@pytest.mark.cuda
@pytest.mark.parametrize("nb,m,d1,d2", DD_CARD_SHAPES)
def test_dd_kernels_match_plain_on_card(nb, m, d1, d2):
    """D1, D2 and D3 against their plain versions on the same inputs on the
    card, bit for bit (every operation rounds once, in the plain version's
    order), with one launch a call, D1 and D2 in the regime the library
    picks for m. D3 also on a transposed view (the wrapper's copy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from loraine_tpu_torch.ops import dd_linalg as dl
    from loraine_tpu_torch.ops.dd import DD

    def same(x, y):
        return all(torch.equal(u, v) for u, v in zip(x, y))

    rng = np.random.default_rng(nb * 1000 + m)
    A = _dd_on_card(spectrum_matrix("clustered", m, nb, seed=m), rng)
    B = _dd_on_card(rng.standard_normal((nb, m, m)), rng)
    eye = torch.eye(m, dtype=torch.float64, device="cuda").expand(nb, m, m).contiguous()
    V0 = DD(eye, torch.zeros_like(eye))
    sweeps = 6 if m <= 84 else 2
    kernels = (dl.dd_jacobi_cuda, dl.dd_chol_cuda, dl.dd_matmul_cuda)
    assert (dl.regime_for("jacobi", m), dl.regime_for("chol", m)) == (d1, d2)
    before = [f.launches for f in kernels]
    by_regime = [dl.dd_jacobi_cuda.launches_by_regime[d1], dl.dd_chol_cuda.launches_by_regime[d2]]
    C, L, J = dl.dd_matmul_cuda(A, B), dl.dd_chol_cuda(A), dl.dd_jacobi_cuda(A, V0, sweeps)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(kernels, before)] == [1, 1, 1]
    assert [dl.dd_jacobi_cuda.launches_by_regime[d1] - by_regime[0],
            dl.dd_chol_cuda.launches_by_regime[d2] - by_regime[1]] == [1, 1]
    assert same(C, dl.dd_matmul_plain(A, B))
    assert same(dl.dd_matmul_cuda(dl.dd_transpose(A), B),
                dl.dd_matmul_plain(dl.dd_transpose(A), B))
    Lp = dl.dd_chol_plain(A)
    assert same(L[0], Lp[0]) and torch.equal(L[1], Lp[1]) and bool(L[1].all())
    Jp = dl.dd_jacobi_plain(A, V0, sweeps)
    assert same(J[0], Jp[0]) and same(J[1], Jp[1])


# D1 forced into every cluster size at theta1's m = 56 (1: one block), and
# into "global" with one and with 16 CTAs
@pytest.mark.cuda
@pytest.mark.parametrize("force", [1, 2, 4, 7, 8, 14, 16, -1, -16])
def test_dd_jacobi_every_plan_on_card(force):
    """D1 at (2, 56), two sweeps, in each plan `plan_for` can force, bit for
    bit against its plain version (the angles, the row moves and the
    overlapped next angles do not depend on how the pairs are split)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from loraine_tpu_torch.ops import dd_linalg as dl
    from loraine_tpu_torch.ops.dd import DD

    rng = np.random.default_rng(56)
    A = _dd_on_card(spectrum_matrix("clustered", 56, 2, seed=56), rng)
    V0 = _dd_on_card(np.linalg.qr(rng.standard_normal((2, 56, 56)))[0], rng)
    (J, Jv), regime = dl._jacobi_run(A, V0, 2, force)
    assert regime == ("global" if force < 0 else "block" if force == 1 else "cluster")
    assert dl.plan_for("jacobi", 56, force)[1] == abs(force)
    Jp, Jvp = dl.dd_jacobi_plain(A, V0, 2)
    assert all(torch.equal(u, v) for u, v in zip((*J, *Jv), (*Jp, *Jvp)))


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
def test_dd_eigh_card_matches_cpu(warm):
    """`dd_eigh_jacobi` (D3 in the warm start, D1 for the sweeps) on the card
    against the plain versions' run on the CPU, nb = 2 at the odd m = 7 (the
    padding), cold and warm-started: the eigenvalues within 2e-29 (the CPU
    tests' mpmath tolerance) and the card's V^T V - I within 1e-28. Not bit
    for bit: torch's vectorized CPU sqrt is not correctly rounded (one ulp
    off on ~0.6% of uniform inputs against numpy's on an AVX512 build),
    the card's is, as D1's `__dsqrt_rn`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from loraine_tpu_torch.ops import dd_linalg as dl
    from loraine_tpu_torch.ops.dd import DD, dd_to_f64

    rng = np.random.default_rng(7)
    M = dl.dd_sym(_dd_on_card(spectrum_matrix("clustered", 7, 2, seed=7), rng))
    V0 = torch.linalg.eigh(M.hi)[1] if warm else None
    before = dl.dd_jacobi_cuda.launches
    lam, V = dl.dd_eigh_jacobi(M, V0=V0)
    ref, _ = dl.dd_eigh_jacobi(DD(M.hi.cpu(), M.lo.cpu()), V0=None if V0 is None else V0.cpu())
    assert dl.dd_jacobi_cuda.launches == before + 1
    diff = (lam.hi.cpu() - ref.hi) + (lam.lo.cpu() - ref.lo)
    assert float(diff.abs().max()) < 2e-29
    VtV = dd_to_f64(dl.dd_matmul(dl.dd_transpose(V), V)).cpu()
    assert float((VtV - torch.eye(7, dtype=torch.float64)).abs().max()) < 1e-28


@pytest.mark.cuda
def test_spans_link_device_work_and_add_no_device_range():
    """A profiled solve on the card: one ``ltt.step`` an iteration, and the
    spans (operator-scope ranges, `utils/timers.py:span`) leave no range of
    their own among the device activities."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device side of a trace exists only on a card")
    import os

    import loraine_tpu_torch as ltt

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "tru3.dat-s")
    opts = {"kit": 0, "eDIMACS": 1e-7, "initpoint": 1, "verb": 0}
    problem = ltt.problem_from_sdpa(path, device="cuda")
    ltt.solve(problem, opts, device="cuda")  # warm: kernel build, handles
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res = ltt.solve(problem, opts, device="cuda")
    events = prof.profiler.kineto_results.events()
    device = [e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert device, "the trace holds no device activity"
    assert not [n for n in device if n.startswith("ltt.")]
    assert sum(e.name() == "ltt.step" for e in events) == res.iterations == 12
