"""One predictor-corrector IPM iteration. Port of the f64 kit=0 and kit=1
branches of `loraine_tpu/ipm/step.py:build_step`, LP cone included (no
dd/dd2 tiers, no mixed assembly, no sharding: ROADMAP.md Queue A items 12,
13, 14).

Covers the reference's `myIPstep` (`src/Solvers.jl:448-478`) and
`check_convergence` (`:496-568`): mu, NT scaling, residuals, Schur assembly
+ regularized Cholesky + one refinement step, predictor directions and
steplengths, Mehrotra sigma, corrector, iterate update and the six DIMACS
errors, with the LP cone's terms beside the LMI blocks' (`find_step_lin`,
`src/predictor_corrector.jl:329-347`). Steplengths come from the certified
spectral bounds of the B2 kernel (`ops/jacobi.py`); the predictor uses the
identity scaleX = -I - scaleS, so one bound computation on scaleS gives
both steplengths (`ipm/step.py:189-200, 426-433`).

Convergence-error convention (reference): err1/err3 use the residuals at
the start of the iteration, err2/4/5/6 the updated iterate.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import Options, resolve_cg_kernel
from ..ops.cg import cg_plain, pcg
from ..ops.jacobi import eig_bounds_jacobi
from ..ops.linalg import btrace, chol_reg, cho_solve_inv, sym, tri_inv
from ..ops.nt_scaling import NTScaling, nt_scale
from ..ops.pcg import cg_f64, pcg_kernel_ff, pcg_kernel_mixed
from ..ops.precond import prep_alpha, prep_beta
from ..ops.schur import Aadj, Aop, lp_weight, schur_group, schur_lp
from ..problem import SDPProblem
from .initial import EXPON, TAU
from .state import IPMState, StepStats

__all__ = ["step"]

_STEP_EPS = -1e-6  # "essentially feasible direction" threshold


def _steplen(ev: torch.Tensor) -> torch.Tensor:
    """alpha = 0.99 if lambda_min > -1e-6 else min(1, -tau/lambda_min)
    (`src/predictor_corrector.jl:274-291`)."""
    return torch.where(ev > _STEP_EPS, torch.full_like(ev, 0.99),
                       (-TAU / ev).clamp(max=1.0))


def _safe_pow(base: torch.Tensor, expo: torch.Tensor) -> torch.Tensor:
    return torch.exp(expo * torch.log(base.clamp_min(1e-300)))


def _gersh_violation(M: torch.Tensor) -> torch.Tensor:
    """max(0, -Gershgorin lower bound) per batch element."""
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    gersh = (diag - (M.abs().sum(-1) - diag.abs())).amin(-1)
    return (-gersh).clamp_min(0.0)


class _GroupDirs(NamedTuple):
    delX: torch.Tensor
    delS: torch.Tensor
    alpha: torch.Tensor  # [nb]
    beta: torch.Tensor  # [nb]


def _group_dirs(
    g,
    nt: NTScaling,
    Rd: torch.Tensor,
    X: torch.Tensor,
    dely: torch.Tensor,
    *,
    predict: bool,
    sig_mu: Optional[torch.Tensor] = None,
    RNT: Optional[torch.Tensor] = None,
) -> _GroupDirs:
    """Directions and per-block steplengths (`find_step`,
    `src/predictor_corrector.jl:248-293`; `ipm/step.py:_group_dirs`)."""
    GT = nt.G.mT
    delS = Rd - Aadj(g, dely)
    Xi = nt.W @ delS @ nt.W
    if predict:
        delX = sym(-X - Xi)
    else:
        delX = sym(sig_mu * nt.Si - X - Xi + nt.G @ RNT @ GT)

    delSb = GT @ delS @ nt.G
    scaleS = sym(nt.DDsi[:, :, None] * delSb * nt.DDsi[:, None, :])
    if predict:
        # Predictor identity: with Gi X Gi^T = D and DDsi = D^{-1/2},
        # scaleX = -I - scaleS, so lambda_min(scaleX) = -1 - lambda_max(scaleS)
        lo, hi = eig_bounds_jacobi(scaleS)
        alpha = _steplen(-1.0 - hi)
        beta = _steplen(lo)
    else:
        delXb = nt.Gi @ delX @ nt.Gi.mT
        scaleX = sym(nt.DDsi[:, :, None] * delXb * nt.DDsi[:, None, :])
        nb = scaleX.shape[0]
        ev = eig_bounds_jacobi(torch.cat([scaleX, scaleS], dim=0))[0]
        alpha = _steplen(ev[:nb])
        beta = _steplen(ev[nb:])
    return _GroupDirs(delX=delX, delS=delS, alpha=alpha, beta=beta)


class _LinDirs(NamedTuple):
    delX: torch.Tensor
    delS: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor


def _lin_dirs(
    problem: SDPProblem,
    st: IPMState,
    Si_lin: torch.Tensor,
    Rd_lin: torch.Tensor,
    dely: torch.Tensor,
    *,
    predict: bool,
    sig_mu: Optional[torch.Tensor] = None,
    RNT_lin: Optional[torch.Tensor] = None,
) -> _LinDirs:
    """LP-cone directions and steplengths (`find_step_lin`,
    `src/predictor_corrector.jl:329-347`; `ipm/step.py:_lin_dirs`)."""
    delS = Rd_lin - problem.C_lin.mT @ dely
    delX = -st.X_lin - st.X_lin * Si_lin * delS
    if not predict:
        delX = delX + sig_mu * Si_lin + RNT_lin
    mX = (delX / st.X_lin).min()
    mS = (delS / st.S_lin).min()
    return _LinDirs(delX=delX, delS=delS, alpha=_steplen(mX), beta=_steplen(mS))


def _schur(problem: SDPProblem, nts, lpw: Optional[torch.Tensor]) -> torch.Tensor:
    """The symmetrized Schur matrix H = sum over groups of schur_group, plus
    the LP block C_lin diag(lpw) C_lin^T."""
    H = torch.zeros((problem.n, problem.n), dtype=problem.b.dtype, device=problem.device)
    for g, nt in zip(problem.groups, nts):
        H = H + schur_group(g, nt.W, nt.G)
    if problem.nlin:
        H = H + schur_lp(problem.C_lin, lpw)
    return sym(H)


def _polish(Hp: torch.Tensor, rp: torch.Tensor, target: torch.Tensor, maxiter: int):
    """The f64 polish of the kernel route: CG on Hp u = rp from u = 0 until
    ||r|| <= target (`loraine_tpu/ipm/step.py:820-835`). Returns (u,
    iterations).

    On a CUDA tensor it is one launch of the polish kernel (`ops.pcg.cg_f64`)
    with tol2 = target^2 on the device: no host read per CG iteration. That
    is `cg_plain`'s threshold tol^2 (rp . rp) with tol = target / ||rp||,
    the same stopping rule; the kernel differs only by the pAp / rr zero
    guards, which act only where `cg_plain` would produce inf or NaN. On a
    CPU tensor it is `cg_plain`, as in the JAX package."""
    if rp.device.type == "cuda":
        return cg_f64(Hp, rp, target * target, maxiter)
    nrm = torch.linalg.norm(rp)
    tol = target / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    return cg_plain(lambda v: Hp @ v, rp, tol, maxiter)


def _cg_solver(problem: SDPProblem, nts, lpw: Optional[torch.Tensor], opts: Options,
               tol_cg: float, precond_kind: int):
    """The kit=1 Schur solve, rhs -> (dely, CG iterations), for one IPM
    iteration (`loraine_tpu/ipm/step.py:716-853`).

    Materialized route (n <= 512 under 'auto', or 'always'): Hcg assembled
    like the direct path's H, the preconditioner as the matrix Mli with
    M = Mli^T Mli, and then either a CG kernel on Hp = sym(Mli Hcg Mli^T)
    followed by the f64 `cg_plain` polish of any shortfall, or the f64
    `cg_plain` on Hp. Matrix-free route: `pcg` with the operator
    Aop(W Aadj(x) W) + C_lin (lpw * C_lin^T x) and the SMW H_alpha /
    diagonal H_beta."""
    n = problem.n
    mat_cg = opts.cg_materialize == "always" or (opts.cg_materialize == "auto" and n <= 512)
    if mat_cg:
        Hcg = _schur(problem, nts, lpw)
        matvec = lambda x: Hcg @ x  # noqa: E731
    else:
        def matvec(x):
            r = torch.zeros_like(x)
            for g, nt in zip(problem.groups, nts):
                r = r + Aop(g, nt.W @ Aadj(g, x) @ nt.W)
            if problem.nlin:
                r = r + problem.C_lin @ (lpw * (problem.C_lin.mT @ x))
            return r

    if precond_kind == 0:
        precond, Mli = (lambda x: x), None
    elif precond_kind == 1:
        pa = prep_alpha(problem, nts, lpw, opts.erank, opts.aamat, opts.eigh_backend,
                        materialize=mat_cg)
        if mat_cg:
            precond, Mli = pa.apply, pa.Mli
        else:
            precond, Mli = (lambda x: pa.apply_with(problem, x)), None
    else:  # 2 or 4 (the hybrid starts as beta)
        pb = prep_beta(problem, nts, lpw, opts.erank, opts.aamat, opts.eigh_backend)
        precond = pb.apply
        # beta is diagonal: its inverse-Cholesky factor is diag(1/sqrt(d))
        Mli = torch.diag(1.0 / torch.sqrt(pb.diag)) if mat_cg else None

    cg_kernel = resolve_cg_kernel(opts.cg_kernel, n, problem.device)
    use_kernel = mat_cg and cg_kernel in ("ff", "pallas")
    if use_kernel and Mli is None:
        Mli = torch.eye(n, dtype=Hcg.dtype, device=Hcg.device)
    if mat_cg and Mli is not None:
        # the split-preconditioned system, once per IPM iteration for both
        # solves (and the polish)
        MliT = Mli.mT
        Hp = sym(Mli @ Hcg @ MliT)

    if use_kernel:
        kernel_fn = pcg_kernel_ff if cg_kernel == "ff" else pcg_kernel_mixed

        def solve(rhs):
            # Stop where the split route below stops, ||Mli r|| <= tol
            # ||Mli rhs||. The JAX package hands the kernel and the polish
            # tol * ||rhs|| instead: once ||Mli|| < 1 (late theta_G100:
            # ||Mli rhs|| ~ 0.01 ||rhs||) that stops the solve ~30x short
            # and the IPM diverges (ROADMAP Queue C).
            target = tol_cg * torch.linalg.norm(Mli @ rhs)
            nrm = torch.linalg.norm(rhs)
            x, it = kernel_fn(Hcg, Mli, rhs, target / torch.where(nrm > 0, nrm, 1.0),
                              opts.cg_maxiter, Hp=Hp)
            # guaranteed finish: polish any kernel shortfall (a stalled pass
            # returns its best iterate) with the f64 split-preconditioned CG
            u, it2 = _polish(Hp, Mli @ (rhs - Hcg @ x), target, opts.cg_maxiter)
            return x + MliT @ u, it + it2
    elif mat_cg and Mli is not None:
        # split-preconditioned f64 CG: solve (Mli H Mli^T) u = Mli b,
        # x = Mli^T u; the Krylov iterates of PCG with M = Mli^T Mli
        def solve(rhs):
            u, it = cg_plain(lambda v: Hp @ v, Mli @ rhs, tol_cg, opts.cg_maxiter)
            return MliT @ u, it
    else:
        def solve(rhs):
            return pcg(matvec, rhs, precond, tol_cg, opts.cg_maxiter)
    return solve


def step(
    problem: SDPProblem,
    st: IPMState,
    opts: Options,
    tol_cg: Optional[float] = None,
    precond_kind: Optional[int] = None,
) -> Tuple[IPMState, StepStats]:
    """One IPM iteration from ``st``; returns (new state, stats).

    kit=1 only: ``tol_cg`` is the CG tolerance of this iteration (default
    ``opts.tol_cg``; the solver tightens it after every iteration) and
    ``precond_kind`` the preconditioner (default ``opts.preconditioner``;
    the solver's hybrid 4 -> 1 switch changes it between iterations)."""
    dtype, device = problem.b.dtype, problem.device
    nlin = problem.nlin
    denom = problem.sum_msizes + nlin
    zero = torch.zeros((), dtype=dtype, device=device)

    # ---- mu (`find_mu`, src/Solvers.jl:480-494)
    tr = zero
    for X, S in zip(st.X, st.S):
        tr = tr + btrace(X, S)
    if nlin:
        tr = tr + torch.dot(st.X_lin, st.S_lin)
    mu = tr / denom

    # ---- NT scaling (prepare_W)
    nts = tuple(
        nt_scale(X, S, method=opts.nt_method, eigh_backend=opts.eigh_backend)
        for X, S in zip(st.X, st.S)
    )
    nt_ok = torch.ones((), dtype=torch.bool, device=device)
    nt_suspect = torch.zeros((), dtype=torch.bool, device=device)  # certificate broken
    for nt in nts:
        nt_ok = nt_ok & nt.ok
        nt_suspect = nt_suspect | nt.shifted | nt.s_indef
    Si_lin = (1.0 / st.S_lin) if nlin else None
    lpw = lp_weight(st.X_lin, Si_lin) if nlin else None

    # ---- residuals (`predictor`, src/predictor_corrector.jl:8-22)
    Rp = problem.b
    for g, X in zip(problem.groups, st.X):
        Rp = Rp - Aop(g, X)
    if nlin:
        Rp = Rp - problem.C_lin @ st.X_lin
    Rds = tuple(sym(g.C - S - Aadj(g, st.y)) for g, S in zip(problem.groups, st.S))
    Rd_lin = (problem.d_lin - st.S_lin - problem.C_lin.mT @ st.y) if nlin else None

    # ---- predictor RHS (`makeRHS`, src/makeBBBB.jl:221-228)
    h = Rp
    for g, nt, Rd, S in zip(problem.groups, nts, Rds, st.S):
        h = h + Aop(g, nt.W @ (Rd + S) @ nt.W)
    if nlin:
        h = h + problem.C_lin @ (lpw * Rd_lin + st.X_lin)

    # ---- predictor solve
    if opts.kit == 0:
        # Schur assembly + regularized Cholesky (absolute 1e-4 shift,
        # `src/predictor_corrector.jl:74`) + explicit inverse factor
        H = _schur(problem, nts, lpw)
        hc = chol_reg(H, 1e-4, 1000)
        h_shifts, h_ok = hc.shifts, hc.ok
        Hli = tri_inv(hc.L)
        cg_pre = cg_cor = torch.zeros((), dtype=torch.int32, device=device)

        def solve(rhs):
            # one step of iterative refinement (the reference carries it
            # commented out at src/predictor_corrector.jl:98-115)
            x = cho_solve_inv(Hli, rhs)
            return x + cho_solve_inv(Hli, rhs - H @ x), cg_pre
    else:
        # the corrector re-solves with the same operator and preconditioner
        solve = _cg_solver(
            problem, nts, lpw, opts,
            opts.tol_cg if tol_cg is None else tol_cg,
            opts.preconditioner if precond_kind is None else precond_kind,
        )
        h_shifts, h_ok = 0, True

    dely, cg_pre = solve(h)

    # ---- predictor directions + steplengths
    dirs = tuple(
        _group_dirs(g, nt, Rd, X, dely, predict=True)
        for g, nt, Rd, X in zip(problem.groups, nts, Rds, st.X)
    )
    one = torch.ones((), dtype=dtype, device=device)
    if nlin:
        ld = _lin_dirs(problem, st, Si_lin, Rd_lin, dely, predict=True)
        alpha_min, beta_min = ld.alpha, ld.beta
    else:
        alpha_min, beta_min = one, one
    for d in dirs:
        alpha_min = torch.minimum(alpha_min, d.alpha.min())
        beta_min = torch.minimum(beta_min, d.beta.min())

    # trial point + NT correction term (`find_step`,
    # src/predictor_corrector.jl:302-310)
    trXnSn_mat = zero
    RNTs = []
    for nt, d, X, S in zip(nts, dirs, st.X, st.S):
        Xn = X + d.alpha[:, None, None] * d.delX
        Sn = S + d.beta[:, None, None] * d.delS
        trXnSn_mat = trXnSn_mat + btrace(Xn, Sn)
        deed = nt.D[:, :, None] + nt.D[:, None, :]
        N = nt.Gi @ d.delX @ d.delS @ nt.G
        RNTs.append(-(N + N.mT) / deed)
    trXnSn = trXnSn_mat
    RNT_lin = None
    if nlin:
        Xn_lin = st.X_lin + ld.alpha * ld.delX
        Sn_lin = st.S_lin + ld.beta * ld.delS
        trXnSn = trXnSn + torch.dot(Xn_lin, Sn_lin)
        RNT_lin = -(ld.delX * ld.delS) * Si_lin

    # ---- sigma update (`sigma_update`, src/predictor_corrector.jl:148-179)
    step_pred = torch.minimum(alpha_min, beta_min)
    expon_used = torch.where(
        mu > 1e-6,
        torch.where(
            step_pred < 1.0 / math.sqrt(3.0),
            one,
            torch.clamp(3.0 * step_pred**2, min=EXPON),
        ),
        torch.clamp(torch.clamp(3.0 * step_pred**2, max=EXPON), min=1.0),
    )
    ratio = trXnSn / denom / mu
    # the 0.8 fallback tests only the matrix trace, the ratio uses the
    # combined one (`ipm/step.py:994-1001`)
    sigma = torch.where(
        trXnSn_mat < 0,
        torch.full_like(one, 0.8),
        torch.clamp(_safe_pow(ratio, expon_used), max=1.0),
    )
    sig_mu = sigma * mu

    # ---- corrector RHS (`corrector`, src/predictor_corrector.jl:183-192)
    h2 = Rp
    for g, nt, Rd, RNT in zip(problem.groups, nts, Rds, RNTs):
        GT = nt.G.mT
        inner = GT @ Rd @ nt.G + torch.diag_embed(nt.D) - torch.diag_embed(sig_mu / nt.D) - RNT
        h2 = h2 + Aop(g, nt.G @ inner @ GT)
    if nlin:
        tmp = ld.delX * ld.delS * Si_lin - sig_mu * Si_lin
        h2 = h2 + problem.C_lin @ (lpw * Rd_lin + st.X_lin + tmp)
    dely2, cg_cor = solve(h2)

    # ---- corrector directions + final update
    dirs2 = tuple(
        _group_dirs(g, nt, Rd, X, dely2, predict=False, sig_mu=sig_mu, RNT=RNT)
        for g, nt, Rd, X, RNT in zip(problem.groups, nts, Rds, st.X, RNTs)
    )
    if nlin:
        ld2 = _lin_dirs(problem, st, Si_lin, Rd_lin, dely2, predict=False,
                        sig_mu=sig_mu, RNT_lin=RNT_lin)
        amin, bmin = ld2.alpha, ld2.beta
    else:
        amin, bmin = one, one
    for d in dirs2:
        amin = torch.minimum(amin, d.alpha.min())
        bmin = torch.minimum(bmin, d.beta.min())

    y_new = st.y + bmin * dely2
    X_new = tuple(sym(X + amin * d.delX) for X, d in zip(st.X, dirs2))
    S_new = tuple(sym(S + bmin * d.delS) for S, d in zip(st.S, dirs2))
    X_lin_new = (st.X_lin + amin * ld2.delX) if nlin else None
    S_lin_new = (st.S_lin + bmin * ld2.delS) if nlin else None

    # ---- DIMACS errors (`check_convergence`, src/Solvers.jl:496-524).
    # The iterates are feasible by construction (steplengths from certified
    # lower bounds), so err2/err4 are zero unless the NT scaling itself was
    # regularized; then report the Gershgorin violation of the new iterate.
    normb = torch.linalg.norm(problem.b)
    by = torch.dot(problem.b, y_new)
    err1 = torch.linalg.norm(Rp) / (1.0 + normb)
    err2, err3, err4, err6, trCX = zero, zero, zero, zero, zero
    for g, X, S, Rd in zip(problem.groups, X_new, S_new, Rds):
        normC = torch.sqrt((g.C**2).sum((-1, -2)))  # [nb]
        viol = _gersh_violation(torch.cat([X, S], dim=0))
        viol = torch.where(nt_suspect, viol, torch.zeros_like(viol))
        violX, violS = viol[: X.shape[0]], viol[X.shape[0] :]
        err2 = err2 + (violX / (1.0 + normb)).sum()
        err3 = err3 + (torch.sqrt((Rd**2).sum((-1, -2))) / (1.0 + normC)).sum()
        err4 = err4 + (violS / (1.0 + normC)).sum()
        CX = (g.C * X).sum((-1, -2))
        trCX = trCX + CX.sum()
        SX = (S * X).sum((-1, -2))
        err6 = err6 + (SX / (1.0 + CX.abs() + by.abs())).sum()
    if nlin:
        dX = torch.dot(problem.d_lin, X_lin_new)
        normd = torch.linalg.norm(problem.d_lin)
        err2 = err2 + (-X_lin_new.min()).clamp_min(0.0) / (1.0 + normb)
        err3 = err3 + torch.linalg.norm(Rd_lin) / (1.0 + normd)
        err4 = err4 + (-S_lin_new.min()).clamp_min(0.0) / (1.0 + normd)
        err5 = (trCX + dX - by) / (1.0 + trCX.abs() + by.abs())
        err6 = err6 + torch.dot(S_lin_new, X_lin_new) / (1.0 + dX.abs() + by.abs())
    else:
        err5 = (trCX - by) / (1.0 + trCX.abs() + by.abs())

    dimacs = err2 + err3 + err4 + err5.abs() + err6
    if problem.nlmi > 0:
        dimacs = dimacs + err1

    new_state = IPMState(X=X_new, S=S_new, y=y_new, X_lin=X_lin_new, S_lin=S_lin_new,
                         sigma=sigma)
    stats = StepStats(
        obj=-by + problem.b_const,
        mu=mu,
        sigma=sigma,
        err1=err1,
        err2=err2,
        err3=err3,
        err4=err4,
        err5=err5,
        err6=err6,
        dimacs=dimacs,
        alpha_min=amin,
        beta_min=bmin,
        h_shifts=h_shifts,
        h_ok=h_ok,
        nt_ok=nt_ok,
        cg_iter_pre=cg_pre,
        cg_iter_cor=cg_cor,
    )
    return new_state, stats
