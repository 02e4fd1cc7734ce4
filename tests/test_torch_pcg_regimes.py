"""The regimes of the CG kernels of loraine_tpu_torch (csrc/pcg.cu), on the CPU.

The kernels run only on a card (tests/test_torch_cuda.py, chip_smoke.py);
here: the shape rule that picks a regime (`ops/pcg.py::regime_for_cg`,
which mirrors the kernel's byte counts), a torch model of the "cluster"
regime's recurrence held against the plain versions, and the kit=1 route's
polish on a CPU tensor. This file imports no JAX.
"""
import numpy as np
import pytest
import torch

import loraine_tpu_torch.ipm.step as S
from loraine_tpu_torch.ops import pcg as tp
from loraine_tpu_torch.ops.cg import cg_plain

F64, F32 = torch.float64, torch.float32

# the regime of each size: "block" below CLUSTER_FROM = 128, "cluster"
# while 16 blocks hold Hp (f64 n <= 656, f32 n <= 944), then "grid"
REGIMES = {
    F64: {21: "block", 36: "block", 104: "block", 160: "cluster", 164: "cluster", 236: "cluster",
          464: "cluster", 512: "cluster", 656: "cluster", 1000: "grid", 1024: "grid"},
    F32: {21: "block", 36: "block", 104: "block", 160: "cluster", 164: "cluster", 236: "cluster",
          464: "cluster", 512: "cluster", 656: "cluster", 1000: "grid", 1024: "grid"},
}
# the largest n whose Hp each one-launch regime holds
LAST = {(F64, "block"): 169, (F64, "cluster"): 656, (F32, "block"): 240, (F32, "cluster"): 944}


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", sorted(REGIMES[F64]))
def test_regime_for_cg(n, dtype):
    regime = tp.regime_for_cg(n, dtype)
    assert regime == REGIMES[dtype][n]
    assert tp.cg_smem_bytes(regime, n, dtype) <= tp.SMEM_LIMIT
    if regime == "grid":  # past a cluster's capacity
        assert tp.cg_smem_bytes("cluster", n, dtype) > tp.SMEM_LIMIT
    if regime == "cluster":  # where a block holds Hp, only from CLUSTER_FROM
        assert n >= tp.CLUSTER_FROM or tp.cg_smem_bytes("block", n, dtype) > tp.SMEM_LIMIT


@pytest.mark.parametrize("dtype,regime", list(LAST), ids=[f"{d}-{r}" for d, r in
                                                           (("f64", "block"), ("f64", "cluster"),
                                                            ("f32", "block"), ("f32", "cluster"))])
def test_regime_capacity(dtype, regime):
    # the last n a regime holds fits a block's shared memory, the next not
    n = LAST[(dtype, regime)]
    assert tp.cg_smem_bytes(regime, n, dtype) <= tp.SMEM_LIMIT
    assert tp.cg_smem_bytes(regime, n + 1, dtype) > tp.SMEM_LIMIT
    if regime == "cluster":
        assert tp.regime_for_cg(n, dtype) == "cluster"
        assert tp.regime_for_cg(n + 1, dtype) == "grid"


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_cluster_from(dtype):
    n = tp.CLUSTER_FROM
    assert tp.regime_for_cg(n - 1, dtype) == "block"
    assert tp.regime_for_cg(n, dtype) == "cluster"


def test_smem_counts():
    # "block": Hp at an odd row stride, p, 2 x 8 warp partials; "cluster":
    # two barriers (16 bytes), ceil(n / C) rows of Hp, the whole p and r,
    # Hp p and r of the own rows, 2 x 16 block partials and 2 x 16 warp
    # partials, in words of the working type
    assert tp.cg_smem_bytes("block", 104, F64) == 8 * (104 * 105 + 104 + 16)
    assert tp.cg_smem_bytes("block", 21, F32) == 4 * (21 * 21 + 21 + 16)
    assert tp.cg_smem_bytes("cluster", 464, F64, 16) == 16 + 8 * (29 * 464 + 2 * 464 + 58 + 64)
    assert tp.cg_smem_bytes("cluster", 464, F64, 8) == 16 + 8 * (58 * 464 + 2 * 464 + 116 + 64)


# --------------------------------------------------------------------------
# the "cluster" regime's recurrence, modelled in torch
# --------------------------------------------------------------------------


def _nonzero(v):
    return torch.where(v != 0, v, torch.ones_like(v))


def _tree(parts):
    """The C <= 16 block partials summed as csrc/pcg.cu::sum_tree sums
    them, in every block: zero-padded to 16, then v[i] += v[i + 8],
    v[i] += v[i + 4], and (v0 + v2) + (v1 + v3)."""
    v = list(parts) + [torch.zeros((), dtype=parts[0].dtype)] * (16 - len(parts))
    v = [v[i] + v[i + 8] for i in range(8)]
    v = [v[i] + v[i + 4] for i in range(4)]
    return (v[0] + v[2]) + (v[1] + v[3])


def cluster_model(Hp, b, tol2, maxiter: int, stall_max, C: int):
    """csrc/pcg.cu::cg_cluster_kernel with C blocks: block q owns rows
    [q n / C, (q+1) n / C) of Hp, x and r; pAp and rr are the C block
    partials summed in one fixed order; every block recomputes the whole
    p = r + beta p from the whole r. With ``stall_max`` the min-residual
    iterate and the stall exit (B3), else the last iterate."""
    n = b.shape[0]
    cuts = [q * n // C for q in range(C + 1)]
    x, r, p = torch.zeros_like(b), b.clone(), b.clone()
    rr = torch.dot(b, b)
    best, best_x = rr, x.clone()
    it = stall = 0
    while bool(rr > tol2) and it < maxiter and (stall_max is None or stall < stall_max):
        Ap = torch.cat([Hp[lo:hi] @ p for lo, hi in zip(cuts, cuts[1:])])
        alpha = rr / _nonzero(_tree([torch.dot(p[lo:hi], Ap[lo:hi])
                                         for lo, hi in zip(cuts, cuts[1:])]))
        x = x + alpha * p
        r = r - alpha * Ap
        rr_n = _tree([torch.dot(r[lo:hi], r[lo:hi]) for lo, hi in zip(cuts, cuts[1:])])
        p = r + (rr_n / _nonzero(rr)) * p
        if stall_max is not None:
            if bool(rr_n < best):
                best, best_x, stall = rr_n, x.clone(), 0
            else:
                stall += 1
        rr = rr_n
        it += 1
    return (x if stall_max is None else best_x), torch.tensor(it, dtype=torch.int32)


def _system(n, case):
    """The systems of tests/test_torch_cg.py and chip_smoke.py phase 6:
    (a) kappa 1e3, identity preconditioner; (b) kappa 1e8 with the inverse
    Cholesky factor of H + 1e-6 I, b = H x_true. Returns (H, Mli, b, kappa)."""
    rng = np.random.default_rng(n if case == "a" else n + 1)
    cond = 1e3 if case == "a" else 1e8
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    H = (Q * np.logspace(0, -np.log10(cond), n)) @ Q.T
    H = (H + H.T) / 2
    v = rng.standard_normal(n)
    if case == "a":
        return torch.from_numpy(H), torch.eye(n, dtype=F64), torch.from_numpy(v), cond
    L = np.linalg.cholesky(H + 1e-6 * np.eye(n))
    Mli = np.linalg.solve(L, np.eye(n))
    return torch.from_numpy(H), torch.from_numpy(Mli), torch.from_numpy(H @ v), cond


# tolerances of chip_smoke.py phase 6
TOLS = {("B3", "a"): 1e-10, ("B3", "b"): 1e-12, ("B4", "a"): 1e-10, ("B4", "b"): 1e-9}


@pytest.mark.parametrize("kernel", ["B3", "B4"])
@pytest.mark.parametrize("case", ["a", "b"])
@pytest.mark.parametrize("n", [21, 104, 464])
def test_cluster_model_matches_plain(n, case, kernel):
    # the same CG as the plain version with other summation orders: both
    # meet the tolerance, x within kappa * tol * 10, iterations within
    # 10% + 2 (chip_smoke.py:check, phase 6)
    H, Mli, b, kappa = _system(n, case)
    tol = TOLS[(kernel, case)]
    C = tp.CLUSTER_BLOCKS
    if kernel == "B3":
        wrapper, plain = tp.pcg_kernel_ff, tp.cg_minres_plain

        def model(Hp, rhs, tol2, maxiter, stall):
            return cluster_model(Hp, rhs, tol2, maxiter, stall, C)
    else:
        wrapper, plain = tp.pcg_kernel_mixed, tp.cg_f32_plain

        def model(Hp, rhs, tol2, maxiter):
            return cluster_model(Hp, rhs, tol2, maxiter, None, C)
    xm, im = wrapper(H, Mli, b, tol, 10000, body=model)
    xp, ip = wrapper(H, Mli, b, tol, 10000, body=plain)
    for x in (xm, xp):
        assert torch.linalg.norm(b - H @ x) <= tol * torch.linalg.norm(b)
    assert (xm - xp).abs().max() <= kappa * tol * 10 * xp.abs().max()
    assert abs(int(im) - int(ip)) <= 0.1 * int(ip) + 2


def test_cluster_model_stall_exit():
    # B3's stall exit and min-residual iterate survive the block split: at
    # kappa 1e14 with tol2 = 0 the model stops after the same kind of
    # plateau as the plain version, with an iterate no worse than x = 0
    rng = np.random.default_rng(7)
    n = 21
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    H = torch.from_numpy((Q * np.logspace(0, -14, n)) @ Q.T)
    H = (H + H.T) / 2
    b = torch.from_numpy(rng.standard_normal(n))
    b = b / torch.linalg.norm(b)
    zero = torch.tensor(0.0, dtype=F64)
    x, it = cluster_model(H, b, zero, 5000, tp.stall_limit(n), 16)
    _, it_p = tp.cg_minres_plain(H, b, zero, 5000, tp.stall_limit(n))
    assert tp.stall_limit(n) < int(it) < 5000 and tp.stall_limit(n) < int(it_p) < 5000
    assert float(torch.linalg.norm(b - H @ x)) <= 1.0 and bool(torch.isfinite(x).all())


# --------------------------------------------------------------------------
# the polish of the kit=1 kernel route
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rp_kind", ["residual", "zero"])
def test_polish_on_cpu_is_cg_plain(rp_kind):
    # on a CPU tensor `_polish` is `cg_plain` with tol = target / ||rp||,
    # bit for bit (the CPU tests keep their parity with the JAX package)
    H, _, b, _ = _system(36, "a")
    rp = b if rp_kind == "residual" else torch.zeros_like(b)
    target = 1e-9 * torch.linalg.norm(b)
    u, it = S._polish(H, rp, target, 500)
    nrm = torch.linalg.norm(rp)
    u_ref, it_ref = cg_plain(lambda v: H @ v, rp, target / torch.where(nrm > 0, nrm, 1.0), 500)
    assert torch.equal(u, u_ref) and torch.equal(it, it_ref)
    assert (int(it) > 0) == (rp_kind == "residual")


def test_polish_plain_version_meets_the_same_target():
    # the polish kernel's plain version (`cg_f64_plain`, tol2 = target^2)
    # stops where `cg_plain` does and agrees with it to rounding
    H, _, b, _ = _system(104, "a")
    target = 1e-10 * torch.linalg.norm(b)
    x, it = tp.cg_f64(H, b, target * target, 1000)  # a CPU tensor: the plain version
    x_ref, it_ref = cg_plain(lambda v: H @ v, b, 1e-10, 1000)
    assert int(it) == int(it_ref)
    assert float((x - x_ref).abs().max()) <= 1e-12 * float(x_ref.abs().max())
    assert torch.linalg.norm(b - H @ x) <= target
