"""ADMM (boundary-point) SDP solver. Port of `loraine_tpu/ipm/admm.py`.

The alternating-direction augmented-Lagrangian method of Wen, Goldfarb, Yin
(Math. Prog. Comp. 2010), the reference's unshipped extra
(`TBD/admm_sdp.jl:6-316`): y from a linear solve against a fixed A A^T
Cholesky factor, S by eigenvalue projection onto the PSD cone, a relaxed
multiplier update for X and an adaptive penalty mu, on the batched block
groups. The JAX package runs the iteration in jitted `lax.while_loop`
chunks; here a chunk is ``chunk`` queued iterations with the same stop
rule: an iteration runs while err > eps (a NaN err stops it too), and once
one stops the rest of the chunk leaves the carry frozen (`torch.where`), so
the iteration count is exact. The host reads err once a chunk and stops at
err <= eps, a non-finite err, or ``maxiter`` (checked, as there, only at a
chunk's end). A chunk in which the solve converges computes its frozen
iterations all the same, at most ``chunk`` - 1 of them.

The PSD projection is the library's f64 `eigh` (cuSOLVER on the card,
LAPACK on the CPU) unless ``eigh_backend`` resolves to 'jacobi' (the eager
f64 Jacobi of `ops/eigh.py`), as the JAX package sends everything but
'jacobi' to `jnp.linalg.eigh`; 'auto' resolves to 'pallas' in the port and
so takes the library `eigh`. No Jacobi kernel runs here.

Solves the same problem as the IPM:  max b'y  s.t.  sum_j y_j A_j <= C,
C_lin' y <= d_lin. Useful when a moderate-accuracy solution is enough or as
a warm-start generator for the IPM.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..ops.eigh import eigh_backend_for, eigh_jacobi
from ..ops.linalg import cho_solve, chol_reg, eigh_or_nan, sym
from ..ops.schur import Aadj, Aop, schur_group, schur_lp
from ..problem import SDPProblem
from .solver import STATUS_NAMES

__all__ = ["solve_admm", "ADMMResult"]

# reference parameter block (`TBD/admm_sdp.jl:31-42`)
_MU0 = 10.01
_RHO = (1.0 + np.sqrt(5.0)) / 2.0 - 0.5
_GAMMA = 0.5
_MU_MIN, _MU_MAX = 1e-4, 1e4
_ETA1, _ETA2 = 10000.0, 100.0
_H4 = 100


@dataclasses.dataclass
class ADMMResult:
    status: int
    status_name: str
    objective: float  # -b'y + b_const (same reporting as the IPM)
    y: np.ndarray
    X: List[np.ndarray]
    S: List[np.ndarray]
    X_lin: Optional[np.ndarray]
    iterations: int
    err: float
    solve_time: float


def _proj_psd(V: torch.Tensor, backend: str) -> torch.Tensor:
    if eigh_backend_for(backend, V.shape[-1]) == "jacobi":
        lam, Q = eigh_jacobi(V)
    else:
        lam, Q = eigh_or_nan(V)
    lam = lam.clamp_min(0.0)
    return sym((Q * lam[:, None, :]) @ Q.mT)


def solve_admm(
    problem: SDPProblem,
    eps: float = 1e-5,
    maxiter: int = 20000,
    verb: int = 1,
    chunk: int = 100,
    eigh_backend: str = "auto",
) -> ADMMResult:
    """Run ADMM on ``problem`` on the device it lives on."""
    dtype, device = problem.b.dtype, problem.device
    n, nlin = problem.n, problem.nlin
    # the sign convention of the JAX package: b as-is and y = -AAT^{-1} rhs
    # converge to the IPM's y (objective -b'y + b_const)
    b = problem.b

    def eye_stack(g):
        return torch.eye(g.m, dtype=dtype, device=device).expand(g.nb, g.m, g.m)

    # fixed normal matrix A A^T = sum <A_j, A_k> (+ C_lin C_lin'): the Schur
    # assembly with W = G = I
    AAT = torch.zeros((n, n), dtype=dtype, device=device)
    for g in problem.groups:
        I_ = eye_stack(g)
        AAT = AAT + schur_group(g, I_, I_)
    if nlin:
        AAT = AAT + schur_lp(problem.C_lin, torch.ones(nlin, dtype=dtype, device=device))
    Lchol = chol_reg(sym(AAT), 1e-10, 50).L

    norm_b = torch.linalg.norm(b)
    normC1 = [g.C.abs().sum((-1, -2)) for g in problem.groups]  # [nb]
    normd1 = problem.d_lin.abs().sum() if nlin else None

    y = torch.ones(n, dtype=dtype, device=device)
    X = tuple(eye_stack(g).clone() for g in problem.groups)
    S = X
    Xl = torch.ones(nlin, dtype=dtype, device=device)
    Sl = Xl
    mu = torch.tensor(_MU0, dtype=dtype, device=device)
    itp = torch.zeros((), dtype=torch.int32, device=device)
    itd = torch.zeros((), dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    carry = (y, X, S, Xl, Sl, mu, itp, itd)

    def one_iter(y, X, S, Xl, Sl, mu, itp, itd):
        Axb = torch.zeros(n, dtype=dtype, device=device)
        ASC = torch.zeros(n, dtype=dtype, device=device)
        for g, Xg, Sg in zip(problem.groups, X, S):
            Axb = Axb + Aop(g, Xg)
            ASC = ASC + Aop(g, Sg - g.C)
        if nlin:
            Axb = Axb + problem.C_lin @ Xl
            ASC = ASC + problem.C_lin @ (Sl - problem.d_lin)

        rhs = mu * (Axb - b) + ASC
        y = -cho_solve(Lchol, rhs)

        newX, newS = [], []
        dinf = dinfs = dgap = dgaps = zero
        for g, Xg, nC1 in zip(problem.groups, X, normC1):
            Vp = g.C - Aadj(g, y)
            V = Vp - mu * Xg
            Sg = _proj_psd(V, eigh_backend)
            Xp = (Sg - V) / mu
            Xg_new = (1.0 - _RHO) * Xg + _RHO * Xp
            newX.append(Xg_new)
            newS.append(Sg)
            di = torch.sqrt(((Vp - Sg) ** 2).sum((-1, -2)))  # [nb]
            dinf = dinf + di.sum()
            dinfs = dinfs + (di / (1.0 + nC1)).sum()
            dg = torch.einsum("bpq,bpq->b", g.C, Xg_new)
            dgap = dgap + dg.sum()
            dgaps = dgaps + dg.abs().sum()
        if nlin:
            Vpl = problem.d_lin - problem.C_lin.mT @ y
            Vl = Vpl - mu * Xl
            Sl = Vl.clamp_min(0.0)
            Xl = (1.0 - _RHO) * Xl + _RHO * (Sl - Vl) / mu
            di = torch.linalg.norm(Vpl - Sl)
            dinf = dinf + di
            dinfs = dinfs + di / (1.0 + normd1)
            dg = torch.dot(problem.d_lin, Xl)
            dgap = dgap + dg
            dgaps = dgaps + dg.abs()

        pinf = torch.linalg.norm(Axb - b)
        pinfs = pinf / (1.0 + norm_b)
        by = torch.dot(b, y)
        dgap_t = (by - dgap).abs()
        dgaps_t = dgap_t / (1.0 + by.abs() + dgaps)
        err = torch.maximum(pinfs, torch.maximum(dinfs, dgaps_t))

        # penalty adaptation (`TBD/admm_sdp.jl:266-282`)
        cond = pinf + dinf > 2.0
        ratio = pinf / dinf.clamp_min(1e-300)
        primal_slow = cond & (ratio < _ETA1)
        dual_slow = cond & (ratio > _ETA2)
        itp = torch.where(primal_slow, itp + 1, torch.where(dual_slow, 0, itp))
        itd = torch.where(dual_slow, itd + 1, torch.where(primal_slow, 0, itd))
        shrink = itp > _H4
        grow = itd > _H4
        mu = torch.where(shrink, (_GAMMA * mu).clamp_min(_MU_MIN), mu)
        mu = torch.where(grow, (mu / _GAMMA).clamp_max(_MU_MAX), mu)
        itp = torch.where(shrink, 0, itp)
        itd = torch.where(grow, 0, itd)
        return y, tuple(newX), tuple(newS), Xl, Sl, mu, itp, itd, err

    t0 = time.perf_counter()
    if verb > 0:
        print(" *** ADMM (boundary point) STARTS")
        print("  iter      error          mu       objective")
    def keep(active, new, old):
        if isinstance(old, tuple):
            return tuple(keep(active, a, b) for a, b in zip(new, old))
        return torch.where(active, new, old)

    err_t = torch.ones((), dtype=dtype, device=device)
    count_t = torch.zeros((), dtype=torch.int64, device=device)
    while True:
        # one chunk: `lax.while_loop` while err > eps, at most ``chunk``
        # iterations, with no host read inside it
        for _ in range(chunk):
            active = err_t > eps
            *new, new_err = one_iter(*carry)
            carry = keep(active, tuple(new), carry)
            err_t = torch.where(active, new_err, err_t)
            count_t = count_t + active
        err, count = float(err_t), int(count_t)
        if verb > 0:
            obj = -float(torch.dot(b, carry[0])) + problem.b_const
            print(f"{count:6d}   {err:.3e}   {float(carry[5]):9.4f}   {obj:.8f}")
        if err <= eps or count >= maxiter or not math.isfinite(err):
            break
    solve_time = time.perf_counter() - t0

    y, X, S, Xl, Sl = carry[:5]
    status = 1 if err <= eps else 4
    Xb: List[Optional[np.ndarray]] = [None] * problem.nlmi
    Sb: List[Optional[np.ndarray]] = [None] * problem.nlmi
    for g, Xg, Sg in zip(problem.groups, X, S):
        Xh, Sh = Xg.cpu().numpy(), Sg.cpu().numpy()
        for bpos, (oidx, osize) in enumerate(zip(g.orig_indices, g.orig_sizes)):
            Xb[oidx] = Xh[bpos, :osize, :osize]
            Sb[oidx] = Sh[bpos, :osize, :osize]
    yh = y.cpu().numpy()
    by = float(np.dot(b.cpu().numpy(), yh))
    return ADMMResult(
        status=status,
        status_name=STATUS_NAMES.get(status, "UNKNOWN"),
        objective=-by + problem.b_const,
        y=yh,
        X=Xb,
        S=Sb,
        X_lin=None if nlin == 0 else Xl.cpu().numpy(),
        iterations=count,
        err=err,
        solve_time=solve_time,
    )
