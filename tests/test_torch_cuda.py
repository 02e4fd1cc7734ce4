"""The CUDA kernels of loraine_tpu_torch (ops/jacobi.py, ops/pcg.py) on a card.

Needs an NVIDIA GPU (marker `cuda`; skips without one). This file imports
neither jax nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from loraine_tpu_torch.ops import jacobi as tj, pcg as tp
from torch_cases import spectrum_matrix


# one shape per regime of each kernel (B1, B2): (sm, sm), (sm, sm),
# (cluster, cluster), (cluster, sm), (cluster, cluster), (rounds, rounds),
# (sm, sm) past one wave of B1's clusters
@pytest.mark.cuda
@pytest.mark.parametrize("nb,m", [(1, 56), (2, 56), (1, 800), (1, 176), (1, 240), (1, 1000),
                                  (4, 144)])
def test_kernels_match_plain_on_card(nb, m):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    A = torch.from_numpy(spectrum_matrix("clustered", m, nb, seed=m)).cuda()
    Mn, scale = tj._normalize_pad(A)
    mp = Mn.shape[-1]
    s1, s2 = tj.jacobi_sweeps_for(m), tj.bound_sweeps_for(m)
    kernels = ((tj.jacobi_eigh_cuda, True), (tj.jacobi_bounds_cuda, False))
    before = [fn.launches_by_regime.copy() for fn, _ in kernels]
    out_k = tj.jacobi_eigh_cuda(Mn, s1)
    g_h = tj.jacobi_bounds_cuda(Mn, s2)
    for (fn, eigvecs), old in zip(kernels, before):  # one launch, in the shape's regime
        assert fn.launches_by_regime - old == {tj.regime_for(nb, mp, eigvecs): 1}
    out_p = tj.jacobi_eigh_plain(Mn, s1)
    torch.cuda.synchronize()
    # every regime rounds each operation once, in the plain version's order
    # (csrc/jacobi.cu): B1 equals the plain version's tensor ops bit for bit
    assert all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    # the contracts of tests/test_jacobi_pallas.py on the sorted seed and the
    # certified bounds (B2's row sums add in another order than torch's)
    lam_k, V = tj._sorted_eigh(*out_k, m, scale)
    lam_p, _ = tj._sorted_eigh(*out_p, m, scale)
    lo_k, hi_k = tj._widened_bounds(*g_h, m, scale, A.dtype)
    lo_p, hi_p = tj._widened_bounds(*tj.jacobi_bounds_plain(Mn, s2), m, scale, A.dtype)
    ev = torch.linalg.eigvalsh(A)
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
    for lo, hi in ((lo_k, hi_k), (lo_p, hi_p)):
        assert (lo <= ev[:, 0]).all() and (hi >= ev[:, -1]).all()
    # the net of chip_smoke.py: per instance the slack is rounding luck on
    # clustered spectra (60 seeds at m=56: medians 1.50e-4 kernel, 1.43e-4
    # plain); fail only a kernel looser than twice the plain bound and 1e-3
    slack_k = (torch.maximum(ev[:, 0] - lo_k, hi_k - ev[:, -1]) / scale).max()
    slack_p = (torch.maximum(ev[:, 0] - lo_p, hi_p - ev[:, -1]) / scale).max()
    assert slack_k < max(1e-3, 2 * float(slack_p))


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
