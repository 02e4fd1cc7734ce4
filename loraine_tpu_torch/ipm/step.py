"""One predictor-corrector IPM iteration. Port of the kit=0 and kit=1
branches of `loraine_tpu/ipm/step.py:build_step` at precision 'f64', 'dd'
and 'dd2', LP cone included, under every ``step_eig``, ``eigh_backend``,
``nt_method``, ``assembly_precision`` and ``nt_precision``, on one device
or on a ('blocks', 'schur') mesh.

Covers the reference's `myIPstep` (`src/Solvers.jl:448-478`) and
`check_convergence` (`:496-568`): mu, NT scaling, residuals, Schur assembly
+ regularized Cholesky + one refinement step, predictor directions and
steplengths, Mehrotra sigma, corrector, iterate update and the six DIMACS
errors, with the LP cone's terms beside the LMI blocks' (`find_step_lin`,
`src/predictor_corrector.jl:329-347`).

The step reads concrete options: its caller resolves every 'auto' first
(`Options.resolved`, `config.py`; `Solver` does), and it refuses one left
(`require_resolved`).

Steplengths (`_bound_fns`, `loraine_tpu/ipm/step.py:372-464`): under
``step_eig`` 'pallas' (what 'auto' resolves to on every device here) the
certified spectral bounds of the B2 kernel (`ops/jacobi.py`), with the
predictor identity scaleX = -I - scaleS, so one bound computation on scaleS
gives both predictor steplengths; under 'exact' the smallest eigenvalue
from ``eigh_backend`` ('pallas' B2, 'mixed', 'jacobi' or 'xla'), under
'chol' the Cholesky bisection and under 'lanczos' the Lanczos bound, each
on [scaleX; scaleS] (the two-matrix path). 'lanczos' carries no
certificate, so it keeps the explicit Cholesky PSD probe of the new
iterate for err2/err4.

``mixed_assembly`` (assembly_precision 'f32' before the handover,
`ipm/solver.py`): the Schur matrix of kit=0 and of the kit=1 materialized
route comes from `schur_group_mixed` and `schur_lp_mixed` (f32 GEMMs on
dense and LP data); everything else stays exact.

``gemm_backend='int8'``: the rank-1 Schur products of kit=0 and of the
kit=1 materialized route are the integer Ozaki GEMM (`ops/int8gemm.py`,
the O1/O2 kernels on a card). ``chol_backend='mixed'``: the NT scaling's
and the kit=0 Schur `chol_reg` factor with the f32-panel Cholesky
(`ops/mixed_chol.py`), except on a row-split mesh, where the Schur factor
is the distributed f64 one.

Convergence-error convention (reference): err1/err3 use the residuals at
the start of the iteration, err2/4/5/6 the updated iterate.

On a sharded problem (`parallel/mesh.py`) each rank steps its own blocks,
and the step completes every reduction over a sharded axis:
traces and DIMACS sums over 'blocks' (`ops/schur.py:bsum`), steplength
minima and the NT flags min/max-reduced over 'blocks', the data operators'
collectives inside `Aop`/`Aadj`. When 'schur' splits the rows, H stays in
row shards through `chol_reg`, `tri_inv` and `cho_solve_inv` (`ops/
linalg.py`, the distributed blocked factorization), and the kit=1
materialized route gathers its Hcg whole on every rank once an iteration,
then takes the unsharded CG route on it, B3/B4 on a card included (the
JAX package keeps its Pallas CG off a sharded schur axis,
`loraine_tpu/ipm/step.py:801-806`, because there Hcg stays sharded); the
matrix-free route's matvec `Aop(W Aadj(x) W)` runs the operators'
collectives. With the rows whole (a 'schur' axis of 1), H is replicated
after the 'blocks' sum and every route is the unsharded one. Under
'dd'/'dd2' the dd sums over 'blocks' (mu's trace, the trial trace, <C, X>)
run through `Mesh.reduce_dd` (`ops/schur.py:bsum_dd`), the dd operators
shard as the f64 ones do, and the kit=0 dd refinement multiplies by this
rank's rows of H in dd and gathers the product over 'schur'. Without a
mesh every path is the unsharded one, op for op.

precision='dd' (the stand-in for the reference's Float64xN solver,
`README.md:37-54`): the residuals, the right-hand sides, the Schur matrix
(`ops/schur.py` dd operators, Ozaki-exact GEMMs) and the Schur solve's
refinement run in double-double, the solve returns dely as a dd pair, and
the directions are feasibility-exact, delX = -T + W Aadj(dely) W (+ U) with
the same T and U as the right-hand sides. No predictor identity there: B2
bounds the concatenated [scaleX; scaleS], as the JAX package's dd mode does.
precision='dd2' also keeps the iterates as dd pairs (the state's ``*_lo``
tails), with mu, the dual residuals, the LP scaling, sigma*mu, the iterate
updates and the complementarity errors in dd. On kit=1 both tiers wrap f64
`pcg` in two dd refinement passes; the CG kernels (B3, B4, the polish) are
not taken, as the JAX package turns its fused CG kernel off in dd mode.

nt_precision='dd' (with 'dd2' only): the NT scaling of `nt_scale_dd`, in
dd from the dd iterates, whose tails (D_lo, G_lo, W_lo) enter every W and
G sandwich that feeds the Schur assembly, the right-hand sides and the
directions, and the corrector's target sig_mu / D in dd
(`loraine_tpu/ipm/step.py:128-168, 597-609, 645-649, 865-873,
1019-1044`). 'auto' resolves to it under 'dd2' on a CUDA device on the
direct path (kit=0), where its dd Cholesky, GEMM and Jacobi sweeps are
the kernels D2, D3 and D1, and to the f64 NT scaling on the CPU and on the
CG path (`Options.resolved`; the JAX package's rule with the card in the
TPU's place, but for kit=1).

Under a profiler the step marks its phases as spans (`utils/timers.py:
span`), in order: ``ltt.nt`` (the NT scaling), ``ltt.residuals`` (mu, the
residuals, the predictor's right-hand side), ``ltt.schur`` (the Schur
assembly; on kit=1 the CG solver's set-up), ``ltt.factor`` (kit=0:
`chol_reg` and `tri_inv`), ``ltt.schur_solve`` (the predictor's solve),
``ltt.steplen`` (its directions and steplengths), ``ltt.corrector``
(sigma, the NT correction term, the corrector's right-hand side),
``ltt.schur_solve`` and ``ltt.steplen`` again for the corrector, and
``ltt.update`` (the iterate update and the DIMACS errors). ``ltt.eig``
marks the eigen-work inside ``ltt.nt`` and ``ltt.steplen``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import Options, require_resolved
from ..ops.cg import cg_plain, pcg
from ..ops.dd import DD, dd_add, dd_mul_f64, dd_neg, dd_sum, dd_to_f64, two_prod, two_sum
from ..ops.dd_linalg import dd_const, dd_div, dd_mul
from ..ops.eigh import eigh_jacobi, eigh_mixed, eigmin_lanczos
from ..ops.jacobi import eig_bounds_jacobi
from ..ops.linalg import btrace, chol_reg, cho_solve_inv, eigmin, eigmin_chol, sym, tri_inv
from ..ops.nt_scaling import NTScaling, NTTails, nt_scale, nt_scale_dd
from ..ops.ozaki import acc_matmul, acc_matvec
from ..ops.pcg import cg_f64, pcg_kernel_ff, pcg_kernel_mixed
from ..ops.precond import prep_alpha, prep_beta
from ..ops.schur import (Aadj, Aadj_dd, Aop, Aop_dd, bsum, bsum_dd, gather_rows_dd, lp_weight,
                         schur_group, schur_group_dd, schur_group_mixed, schur_lp, schur_lp_dd,
                         schur_lp_mixed)
from ..problem import SDPProblem
from ..utils.timers import span
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


def _bound_fns(opts: Options):
    """(eigmin_fn, eigrange_fn, cert_mode) of the resolved ``step_eig``
    (`loraine_tpu/ipm/step.py:372-451`; the JAX package's 'auto' is
    'pallas' on the TPU and 'exact' on the CPU, the port's 'pallas' on
    every device). eigmin_fn maps [k, m, m] to a lower bound (or the value)
    of each lambda_min; eigrange_fn, set only under 'pallas', maps scaleS to
    (lambda_min, lambda_max) bounds for the predictor identity; cert_mode is
    False under 'lanczos' only."""
    mode, backend = opts.step_eig, opts.eigh_backend

    def eigmin_fn(M):
        if mode == "chol":
            return eigmin_chol(M)
        if mode == "lanczos":
            return eigmin_lanczos(M)
        if mode == "pallas":
            return eig_bounds_jacobi(M)[0]
        if backend == "jacobi":
            # lambda_min to ~1e-9 relative needs 7 sweeps, not the default
            return eigh_jacobi(M, sweeps=7)[0][..., 0]
        if backend == "mixed":
            return eigh_mixed(M, refine_iters=1)[0][..., 0]
        if backend == "pallas":
            return eig_bounds_jacobi(M)[0]
        return eigmin(M)

    eigrange_fn = eig_bounds_jacobi if mode == "pallas" else None
    return eigmin_fn, eigrange_fn, mode != "lanczos"


def _psd_violation(M: torch.Tensor, suspect: torch.Tensor, cert_mode: bool) -> torch.Tensor:
    """err2/err4's violation of the new iterate per block
    (`loraine_tpu/ipm/step.py:453-464`). Certified steplengths keep the
    iterate PD by construction, so it is 0 unless the NT scaling was
    regularized (``suspect``), and then the Gershgorin violation. Without a
    certificate ('lanczos') a Cholesky probe decides: 0 where it succeeds."""
    viol = _gersh_violation(M)
    report = suspect if cert_mode else torch.linalg.cholesky_ex(M).info != 0
    return torch.where(report, viol, torch.zeros_like(viol))


# ---- double-double helpers (`loraine_tpu/ipm/step.py:80-100`)


def _dd0(x: torch.Tensor) -> DD:
    return DD(x, torch.zeros_like(x))


def _sandwich_dd(L: torch.Tensor, M: torch.Tensor, R: torch.Tensor) -> DD:
    """L M R in dd for batched [nb, m, m] operands (Ozaki GEMMs plus the f64
    lo-part correction)."""
    T1 = acc_matmul(L, M)
    T = acc_matmul(T1.hi, R)
    s = two_sum(T.hi, T1.lo @ R)
    return DD(s.hi, s.lo + T.lo)


def _w_tail(tail: NTTails, W: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """The first-order W-tail terms W_lo M W + W M W_lo of the sandwich
    W M W under the native dd NT scaling."""
    return tail.W_lo @ (M @ W) + (W @ M) @ tail.W_lo


def _trace_dot_dd(A: torch.Tensor, B: torch.Tensor) -> DD:
    """sum over all entries of A * B in dd."""
    return dd_sum(two_prod(A.reshape(-1), B.reshape(-1)))


def _dd_dot(a: torch.Tensor, b: torch.Tensor) -> DD:
    return dd_sum(two_prod(a, b))


def _dd_inner(A: DD, B: DD) -> DD:
    """<A, B> over all entries of two dd tensors: dd on hi x hi, the cross
    terms in f64 (`ipm/step.py:490-500`)."""
    t = _trace_dot_dd(A.hi, B.hi)
    s = two_sum(t.hi, (A.hi * B.lo).sum() + (A.lo * B.hi).sum())
    return DD(s.hi, s.lo + t.lo)


def _cmatvec_dd(M: torch.Tensor, v: DD) -> DD:
    """M @ v for a dd vector: Ozaki-exact on the hi word, plain f64 on the
    lo correction."""
    r = acc_matvec(M, v.hi)
    s = two_sum(r.hi, M @ v.lo)
    return DD(s.hi, s.lo + r.lo)


def _dd_sym(x: DD) -> DD:
    return DD(sym(x.hi), sym(x.lo))


class _GroupDirs(NamedTuple):
    delX: torch.Tensor
    delS: torch.Tensor
    alpha: torch.Tensor  # [nb]
    beta: torch.Tensor  # [nb]
    delX_lo: Optional[torch.Tensor] = None  # dd2: direction tails
    delS_lo: Optional[torch.Tensor] = None


def _group_dirs(
    g,
    nt: NTScaling,
    Rd: torch.Tensor,
    X: torch.Tensor,
    dely,
    *,
    predict: bool,
    eigmin_fn,
    eigrange_fn=None,
    sig_mu: Optional[torch.Tensor] = None,
    RNT: Optional[torch.Tensor] = None,
    T_dd: Optional[DD] = None,
    U_dd: Optional[DD] = None,
    Rd_dd: Optional[DD] = None,
    tail: Optional[NTTails] = None,
) -> _GroupDirs:
    """Directions and per-block steplengths (`find_step`,
    `src/predictor_corrector.jl:248-293`; `ipm/step.py:_group_dirs`).

    dd mode (``T_dd`` given, ``dely`` a DD pair): the feasibility-exact
    delX = -T + W Aadj(dely) W (+ U on the corrector), where dely.lo's
    sandwich keeps A(delX) = Rp past dely's f64 resolution. dd2 (``Rd_dd``
    given): delS from the dd adjoint, and both directions come back with
    their dd tails; ``tail`` (nt_precision='dd') adds the W-tail terms to
    the W sandwich, the same terms the Schur assembly took. The predictor
    identity is taken only with
    ``eigrange_fn`` (step_eig 'pallas') and not in dd mode; otherwise
    ``eigmin_fn`` bounds [scaleX; scaleS] in one call."""
    dd_mode = T_dd is not None
    dd2 = Rd_dd is not None
    GT = nt.G.mT
    if dd_mode:
        if dd2:
            adj = Aadj_dd(g, dely)
            delS_dd = _dd_sym(dd_add(Rd_dd, dd_neg(adj)))
            delS = delS_dd.hi
            # the dd adjoint's hi is the correctly rounded leading word
            WAW = _sandwich_dd(nt.W, adj.hi, nt.W)
            wlo = nt.W @ adj.lo @ nt.W
            if tail is not None:
                wlo = wlo + _w_tail(tail, nt.W, adj.hi)
            WAW = DD(WAW.hi, WAW.lo + wlo)
        else:
            adj = Aadj(g, dely.hi)
            delS = Rd - adj
            WAW = _sandwich_dd(nt.W, adj, nt.W)
            WAW = DD(WAW.hi, WAW.lo + nt.W @ Aadj(g, dely.lo) @ nt.W)
        acc = dd_add(dd_neg(T_dd), WAW)
        if not predict:
            acc = dd_add(acc, U_dd)
        if dd2:
            delX_dd = _dd_sym(acc)
            delX = delX_dd.hi
        else:
            delX = sym(dd_to_f64(acc))
    else:
        delS = Rd - Aadj(g, dely)
        Xi = nt.W @ delS @ nt.W
        if predict:
            delX = sym(-X - Xi)
        else:
            delX = sym(sig_mu * nt.Si - X - Xi + nt.G @ RNT @ GT)

    delSb = GT @ delS @ nt.G
    scaleS = sym(nt.DDsi[:, :, None] * delSb * nt.DDsi[:, None, :])
    if predict and not dd_mode and eigrange_fn is not None:
        # Predictor identity: with Gi X Gi^T = D and DDsi = D^{-1/2},
        # scaleX = -I - scaleS, so lambda_min(scaleX) = -1 - lambda_max(scaleS)
        with span("eig"):
            lo, hi = eigrange_fn(scaleS)
        alpha = _steplen(-1.0 - hi)
        beta = _steplen(lo)
    else:
        delXb = nt.Gi @ delX @ nt.Gi.mT
        scaleX = sym(nt.DDsi[:, :, None] * delXb * nt.DDsi[:, None, :])
        nb = scaleX.shape[0]
        with span("eig"):
            ev = eigmin_fn(torch.cat([scaleX, scaleS], dim=0))
        alpha = _steplen(ev[:nb])
        beta = _steplen(ev[nb:])
    if dd2:
        return _GroupDirs(delX=delX, delS=delS, alpha=alpha, beta=beta,
                          delX_lo=delX_dd.lo, delS_lo=delS_dd.lo)
    return _GroupDirs(delX=delX, delS=delS, alpha=alpha, beta=beta)


def _corrector_U_dd(nt: NTScaling, tail: NTTails, RNT: torch.Tensor, sig_mu_dd: DD) -> DD:
    """The corrector's U = G [sig_mu / D + RNT] G^T under the native dd NT
    scaling (`ipm/step.py:1019-1044`): with D accurate in dd, the quotient
    sig_mu / D in dd (an f64 one would put u64-relative noise back where
    mu sinks below the f64 resolution of the spectrum), and the G-tail
    first-order terms."""
    GT = nt.G.mT
    q = dd_div(DD(sig_mu_dd.hi.expand_as(nt.D), sig_mu_dd.lo.expand_as(nt.D)),
               DD(nt.D, tail.D_lo))
    s = two_sum(torch.diag_embed(q.hi), RNT)
    inner = DD(s.hi, s.lo + torch.diag_embed(q.lo))
    U = _sandwich_dd(nt.G, inner.hi, GT)
    Ulo = (nt.G @ inner.lo @ GT + tail.G_lo @ (inner.hi @ GT)
           + (nt.G @ inner.hi) @ tail.G_lo.mT)
    return DD(U.hi, U.lo + Ulo)


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


def _lin_dirs_dd(
    problem: SDPProblem,
    Xl: DD,
    Sl: DD,
    lpw: DD,
    Rd_lin: DD,
    dely: DD,
    *,
    predict: bool,
    U_lin: Optional[DD] = None,
) -> _LinDirs:
    """LP-cone directions at dd resolution (dd2; `ipm/step.py:_lin_dirs_dd`):
    delX and delS come back as DD pairs. ``U_lin`` = sig_mu*Si + RNT_lin,
    the same term the corrector's right-hand side used."""
    delS = dd_add(Rd_lin, dd_neg(_cmatvec_dd(problem.C_lin.mT, dely)))
    delX = dd_neg(dd_add(Xl, dd_mul(lpw, delS)))
    if not predict:
        delX = dd_add(delX, U_lin)
    mX = (delX.hi / Xl.hi).min()
    mS = (delS.hi / Sl.hi).min()
    return _LinDirs(delX=delX, delS=delS, alpha=_steplen(mX), beta=_steplen(mS))


def _schur(problem: SDPProblem, nts, lpw: Optional[torch.Tensor],
           mixed: bool = False, gemm_backend: str = "f64") -> torch.Tensor:
    """The symmetrized Schur matrix H = sum over groups of schur_group (its
    rank-1 products by ``gemm_backend``, `loraine_tpu/ipm/step.py:664,735`),
    plus the LP block C_lin diag(lpw) C_lin^T; with ``mixed`` the f32
    assembly (`schur_group_mixed`, `schur_lp_mixed`, which keep the rank-1
    groups in f64 as the JAX package does). When the rows are sharded,
    this rank's rows [r0, r1) of H as assembled: the factorization reads
    the lower triangle only, so no transpose is gathered to symmetrize."""
    r0, r1 = problem.shard.rows if problem.rows_split else (0, problem.n)
    H = torch.zeros((r1 - r0, problem.n), dtype=problem.b.dtype, device=problem.device)
    for g, nt in zip(problem.groups, nts):
        H = H + (schur_group_mixed(g, nt.W, nt.G) if mixed
                 else schur_group(g, nt.W, nt.G, gemm_backend))
    lp_fn = schur_lp_mixed if mixed else schur_lp
    if problem.nlin:
        H = H + lp_fn(problem.C_lin, lpw, slice(r0, r1))
    return H if problem.rows_split else sym(H)


def _schur_dd(problem: SDPProblem, nts, tails, lpw: Optional[torch.Tensor],
              lpw_dd: Optional[DD]) -> DD:
    """The symmetrized Schur matrix in dd (`ipm/step.py:642-657`): the dd
    group contributions with the NT tails (``tails``, nt_precision='dd'),
    and the LP block in dd under dd2 (``lpw_dd``) or the f64 one under dd.
    When the rows are sharded, this rank's rows of H as assembled (see
    `_schur`)."""
    r0, r1 = problem.shard.rows if problem.rows_split else (0, problem.n)
    rows = slice(r0, r1) if problem.rows_split else slice(None)
    zero = torch.zeros((r1 - r0, problem.n), dtype=problem.b.dtype, device=problem.device)
    H = DD(zero, zero)
    for g, nt, tl in zip(problem.groups, nts, tails):
        H = dd_add(H, schur_group_dd(g, nt.W, nt.G, W_lo=None if tl is None else tl.W_lo,
                                     G_lo=None if tl is None else tl.G_lo))
    if problem.nlin:
        H = dd_add(H, schur_lp_dd(problem.C_lin, lpw_dd, rows) if lpw_dd is not None
                   else _dd0(schur_lp(problem.C_lin, lpw, rows)))
    return H if problem.rows_split else _dd_sym(H)


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
               tol_cg: float, precond_kind: int, dd_mode: bool = False, mixed: bool = False):
    """The kit=1 Schur solve, rhs -> (dely, CG iterations), for one IPM
    iteration (`loraine_tpu/ipm/step.py:716-853`).

    Materialized route (cg_materialize 'always'): Hcg assembled
    like the direct path's H, the preconditioner as the matrix Mli with
    M = Mli^T Mli, and then either a CG kernel on Hp = sym(Mli Hcg Mli^T)
    followed by the f64 `cg_plain` polish of any shortfall, or the f64
    `cg_plain` on Hp. Matrix-free route: `pcg` with the operator
    Aop(W Aadj(x) W) + C_lin (lpw * C_lin^T x) and the SMW H_alpha /
    diagonal H_beta. Under dd/dd2 (``dd_mode``) every route is `pcg` on the
    route's f64 operator and preconditioner (`ipm/step.py:802-807, 887-899`):
    the caller refines its solution in dd. ``mixed``: Hcg from the f32
    assembly. With dtype='float32' the CG kernels (f64 B3 and polish, and B4
    with its f64 refinement) run on f64 copies of the f32 operator and
    return the solution in f32."""
    n = problem.n
    mat_cg = opts.cg_materialize == "always"
    if mat_cg:
        Hcg = _schur(problem, nts, lpw, mixed, opts.gemm_backend)
        if problem.rows_split:
            # whole on every rank: the CG below is
            # the unsharded route, with no collective inside it
            sh = problem.shard
            Hcg = sym(sh.mesh.gather(Hcg, "schur", n, sh.rows[0]))
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

    if dd_mode:
        def solve(rhs):
            return pcg(matvec, rhs, precond, tol_cg, opts.cg_maxiter)
        return solve

    use_kernel = mat_cg and opts.cg_kernel in ("ff", "pallas")
    if use_kernel and Mli is None:
        Mli = torch.eye(n, dtype=Hcg.dtype, device=Hcg.device)
    if mat_cg and Mli is not None:
        # the split-preconditioned system, once per IPM iteration for both
        # solves (and the polish)
        MliT = Mli.mT
        Hp = sym(Mli @ Hcg @ MliT)

    if use_kernel:
        kernel_fn = pcg_kernel_ff if opts.cg_kernel == "ff" else pcg_kernel_mixed
        dtype = Hcg.dtype
        if dtype != torch.float64:
            Hcg, Mli, MliT, Hp = (t.double() for t in (Hcg, Mli, MliT, Hp))

        def solve(rhs):
            rhs = rhs.double()
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
            return (x + MliT @ u).to(dtype), it + it2
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


def _matvec_dd(problem: SDPProblem, nts, tails, lpw: Optional[torch.Tensor],
               lpw_dd: Optional[DD], x: DD) -> DD:
    """The Schur operator applied in dd to a dd vector, matrix-free
    (`ipm/step.py:863-885`): Aop_dd(W Aadj(x) W) per group, the sandwich in
    dd with x.lo's first-order term (and the W-tail terms under
    nt_precision='dd'), plus the LP block (in dd under dd2)."""
    acc = None
    for g, nt, tl in zip(problem.groups, nts, tails):
        M = Aadj(g, x.hi)
        T = _sandwich_dd(nt.W, M, nt.W)
        tlo = nt.W @ Aadj(g, x.lo) @ nt.W
        if tl is not None:
            tlo = tlo + _w_tail(tl, nt.W, M)
        T = DD(T.hi, T.lo + tlo)
        r = Aop_dd(g, T.hi, T.lo)
        acc = r if acc is None else dd_add(acc, r)
    if problem.nlin:
        C = problem.C_lin
        if lpw_dd is not None:
            r = _cmatvec_dd(C, dd_mul(lpw_dd, _cmatvec_dd(C.mT, x)))
        else:
            r = acc_matvec(C, lpw * (C.mT @ x.hi + C.mT @ x.lo))
        acc = r if acc is None else dd_add(acc, r)
    return acc


def step(
    problem: SDPProblem,
    st: IPMState,
    opts: Options,
    tol_cg: Optional[float] = None,
    precond_kind: Optional[int] = None,
    mixed_assembly: bool = False,
) -> Tuple[IPMState, StepStats]:
    """One IPM iteration from ``st``; returns (new state, stats).

    kit=1 only: ``tol_cg`` is the CG tolerance of this iteration (default
    ``opts.tol_cg``; the solver tightens it after every iteration) and
    ``precond_kind`` the preconditioner (default ``opts.preconditioner``;
    the solver's hybrid 4 -> 1 switch changes it between iterations).
    ``mixed_assembly``: the f32 Schur assembly (the solver's phase of
    assembly_precision 'f32' before DIMACS < 1e-3). ``opts`` holds no
    'auto' (`Options.resolved`).
    precision='dd2' needs the state's tails (`Solver` adds zero tails)."""
    require_resolved(opts)
    dtype, device = problem.b.dtype, problem.device
    nlin = problem.nlin
    ngroups = len(problem.groups)
    denom = problem.sum_msizes + nlin
    zero = torch.zeros((), dtype=dtype, device=device)
    dd_mode = opts.precision in ("dd", "dd2")
    dd2 = opts.precision == "dd2"
    # the native dd NT scaling (`Options.resolved` leaves 'dd' under 'dd2' only)
    nt_dd = opts.nt_precision == "dd"
    mesh = problem.mesh
    C_lin = problem.C_lin
    eigmin_fn, eigrange_fn, cert_mode = _bound_fns(opts)

    # dd2: the iterates as DD pairs (hi = st.X etc., lo = the stored tails)
    if dd2:
        X_dds = tuple(DD(X, Xl) for X, Xl in zip(st.X, st.X_lo))
        S_dds = tuple(DD(S, Sl) for S, Sl in zip(st.S, st.S_lo))
        y_dd = DD(st.y, st.y_lo)
        Xl_dd = DD(st.X_lin, st.X_lin_lo) if nlin else None
        Sl_dd = DD(st.S_lin, st.S_lin_lo) if nlin else None

    # ---- NT scaling (prepare_W): f64 on the hi words, or in dd with tails
    with span("nt"):
        if nt_dd:
            pairs = tuple(nt_scale_dd(Xd, Sd, eigh_backend=opts.eigh_backend, mesh=mesh)
                          for Xd, Sd in zip(X_dds, S_dds))
            nts = tuple(p_[0] for p_ in pairs)
            nt_tails = tuple(p_[1] for p_ in pairs)
        else:
            nts = tuple(
                nt_scale(X, S, method=opts.nt_method, eigh_backend=opts.eigh_backend,
                         chol_backend=opts.chol_backend)
                for X, S in zip(st.X, st.S)
            )
            nt_tails = (None,) * ngroups
        nt_ok = torch.ones((), dtype=torch.bool, device=device)
        nt_suspect = torch.zeros((), dtype=torch.bool, device=device)  # certificate broken
        for nt in nts:
            nt_ok = nt_ok & nt.ok
            nt_suspect = nt_suspect | nt.shifted | nt.s_indef
        if mesh is not None:
            nt_ok = mesh.reduce(nt_ok, "blocks", "min")
            nt_suspect = mesh.reduce(nt_suspect, "blocks", "max")

    # ---- mu (`find_mu`, src/Solvers.jl:480-494), the residuals and the
    # predictor's right-hand side
    with span("residuals"):
        if dd2:
            # <X, S> in dd: near the dd2 floor it cancels over ~20 digits
            tr_dd = _dd0(zero)
            for g, Xd, Sd in zip(problem.groups, X_dds, S_dds):
                tr_dd = dd_add(tr_dd, bsum_dd(g, _dd_inner(Xd, Sd)))
            if nlin:
                tr_dd = dd_add(tr_dd, _dd_inner(Xl_dd, Sl_dd))
            mu = dd_to_f64(tr_dd) / denom
        else:
            tr = zero
            for g, X, S in zip(problem.groups, st.X, st.S):
                tr = tr + bsum(g, btrace(X, S))
            if nlin:
                tr = tr + torch.dot(st.X_lin, st.S_lin)
            mu = tr / denom

        Si_lin_dd = lpw_dd = None
        if nlin and dd2:
            # Si = 1/S and lpw = X/S at dd resolution (`ipm/step.py:531-539`)
            Si_lin_dd = dd_div(dd_const(1.0, st.S_lin), Sl_dd)
            lpw_dd = dd_mul(Xl_dd, Si_lin_dd)
            Si_lin, lpw = Si_lin_dd.hi, lpw_dd.hi
        else:
            Si_lin = (1.0 / st.S_lin) if nlin else None
            lpw = lp_weight(st.X_lin, Si_lin) if nlin else None

        # ---- residuals (`predictor`, src/predictor_corrector.jl:8-22)
        if dd_mode:
            Rp_dd = _dd0(problem.b)
            for gi, (g, X) in enumerate(zip(problem.groups, st.X)):
                Rp_dd = dd_add(Rp_dd, dd_neg(Aop_dd(g, X, X_dds[gi].lo if dd2 else None)))
            if nlin:
                lin = _cmatvec_dd(C_lin, Xl_dd) if dd2 else acc_matvec(C_lin, st.X_lin)
                Rp_dd = dd_add(Rp_dd, dd_neg(lin))
            Rp = dd_to_f64(Rp_dd)
        else:
            Rp = problem.b
            for g, X in zip(problem.groups, st.X):
                Rp = Rp - Aop(g, X)
            if nlin:
                Rp = Rp - C_lin @ st.X_lin
        Rd_dds = (None,) * ngroups
        Rd_lin_dd = None
        if dd2:
            # Rd = C - S - Aadj(y) at dd resolution (f64 would pin err3 at
            # u64 ||C||)
            Rd_dds = []
            for g, Sd in zip(problem.groups, S_dds):
                t = two_sum(g.C, -Sd.hi)
                Rd_dds.append(_dd_sym(dd_add(DD(t.hi, t.lo - Sd.lo), dd_neg(Aadj_dd(g, y_dd)))))
            Rds = tuple(r.hi for r in Rd_dds)
        else:
            Rds = tuple(sym(g.C - S - Aadj(g, st.y)) for g, S in zip(problem.groups, st.S))
        if nlin and dd2:
            t = two_sum(problem.d_lin, -Sl_dd.hi)
            Rd_lin_dd = dd_add(DD(t.hi, t.lo - Sl_dd.lo), dd_neg(_cmatvec_dd(C_lin.mT, y_dd)))
            Rd_lin = Rd_lin_dd.hi
        else:
            Rd_lin = (problem.d_lin - st.S_lin - C_lin.mT @ st.y) if nlin else None

        # ---- predictor RHS (`makeRHS`, src/makeBBBB.jl:221-228)
        T_dds = (None,) * ngroups
        if dd_mode:
            # T = W (Rd + S) W per group, in dd, reused verbatim in the
            # direction formula so that the feasibility identity cancels exactly
            if dd2:
                T_dds = []
                for nt, tl, Rdd, Sd in zip(nts, nt_tails, Rd_dds, S_dds):
                    M_dd = dd_add(Rdd, Sd)
                    T = _sandwich_dd(nt.W, M_dd.hi, nt.W)
                    tlo = nt.W @ M_dd.lo @ nt.W
                    if tl is not None:
                        # keep T consistent with the tailed W of the directions
                        tlo = tlo + _w_tail(tl, nt.W, M_dd.hi)
                    T_dds.append(DD(T.hi, T.lo + tlo))
                T_dds = tuple(T_dds)
            else:
                T_dds = tuple(_sandwich_dd(nt.W, Rd + S, nt.W) for nt, Rd, S in zip(nts, Rds, st.S))
            h_dd = Rp_dd
            for g, T in zip(problem.groups, T_dds):
                h_dd = dd_add(h_dd, Aop_dd(g, T.hi, T.lo))
            if nlin:
                if dd2:
                    v = dd_add(dd_mul(lpw_dd, Rd_lin_dd), Xl_dd)
                    h_dd = dd_add(h_dd, _cmatvec_dd(C_lin, v))
                else:
                    h_dd = dd_add(h_dd, acc_matvec(C_lin, lpw * Rd_lin + st.X_lin))
        else:
            h = Rp
            for g, nt, Rd, S in zip(problem.groups, nts, Rds, st.S):
                h = h + Aop(g, nt.W @ (Rd + S) @ nt.W)
            if nlin:
                h = h + C_lin @ (lpw * Rd_lin + st.X_lin)

    # ---- predictor solve
    if opts.kit == 0:
        # Schur assembly + regularized Cholesky (absolute 1e-4 shift,
        # `src/predictor_corrector.jl:74`) + explicit inverse factor
        with span("schur"):
            if dd_mode:
                Hs_dd = _schur_dd(problem, nts, nt_tails, lpw, lpw_dd)
                H = Hs_dd.hi
            else:
                H = _schur(problem, nts, lpw, mixed_assembly, opts.gemm_backend)
        rmesh = mesh if problem.rows_split else None
        with span("factor"):
            hc = chol_reg(H, 1e-4, 1000, backend=opts.chol_backend, mesh=rmesh)
            h_shifts, h_ok = hc.shifts, hc.ok
            Hli = tri_inv(hc.L, mesh=rmesh)
        cg_pre = cg_cor = torch.zeros((), dtype=torch.int32, device=device)

        if dd_mode:
            def solve(rhs_dd):
                # mixed-precision refinement: f64 factor, dd residuals, the
                # solution returned in dd (`ipm/step.py:685-703`); H x from
                # this rank's rows, gathered over 'schur' when they are split
                x = cho_solve_inv(Hli, rhs_dd.hi, rmesh)
                xlo = torch.zeros_like(x)
                for _ in range(3):
                    Hx = acc_matvec(Hs_dd.hi, x)
                    s = two_sum(Hx.hi, Hs_dd.lo @ x + Hs_dd.hi @ xlo)
                    Hx = gather_rows_dd(problem, DD(s.hi, s.lo + Hx.lo))
                    r = dd_add(rhs_dd, dd_neg(Hx))
                    snew = two_sum(x, cho_solve_inv(Hli, dd_to_f64(r), rmesh))
                    x, xlo = snew.hi, snew.lo + xlo
                return DD(x, xlo), cg_pre
        else:
            def Hmv(x):
                if rmesh is None:
                    return H @ x
                return rmesh.gather(H @ x, "schur", problem.n, problem.shard.rows[0])

            def solve(rhs):
                # one step of iterative refinement (the reference carries it
                # commented out at src/predictor_corrector.jl:98-115)
                x = cho_solve_inv(Hli, rhs, rmesh)
                return x + cho_solve_inv(Hli, rhs - Hmv(x), rmesh), cg_pre
    else:
        # the corrector re-solves with the same operator and preconditioner
        with span("schur"):
            solve_f64 = _cg_solver(
                problem, nts, lpw, opts,
                opts.tol_cg if tol_cg is None else tol_cg,
                opts.preconditioner if precond_kind is None else precond_kind,
                dd_mode=dd_mode, mixed=mixed_assembly,
            )
        h_shifts, h_ok = 0, True
        if dd_mode:
            def solve(rhs_dd):
                # f64 PCG + two dd refinement passes, the solution
                # accumulated in dd (`ipm/step.py:887-899`)
                x, iters = solve_f64(rhs_dd.hi)
                xlo = torch.zeros_like(x)
                for _ in range(2):
                    r = dd_add(rhs_dd, dd_neg(_matvec_dd(problem, nts, nt_tails, lpw, lpw_dd,
                                                         DD(x, xlo))))
                    d, itr = solve_f64(dd_to_f64(r))
                    iters = iters + itr
                    snew = two_sum(x, d)
                    x, xlo = snew.hi, snew.lo + xlo
                return DD(x, xlo), iters
        else:
            solve = solve_f64

    with span("schur_solve"):
        dely, cg_pre = solve(h_dd if dd_mode else h)

    # ---- predictor directions + steplengths
    with span("steplen"):
        dirs = tuple(
            _group_dirs(g, nt, Rd, X, dely, predict=True, eigmin_fn=eigmin_fn,
                        eigrange_fn=eigrange_fn, T_dd=T, Rd_dd=Rdd, tail=tl)
            for g, nt, Rd, X, T, Rdd, tl in zip(problem.groups, nts, Rds, st.X, T_dds, Rd_dds,
                                                nt_tails)
        )
        one = torch.ones((), dtype=dtype, device=device)
        if nlin:
            if dd2:
                ld = _lin_dirs_dd(problem, Xl_dd, Sl_dd, lpw_dd, Rd_lin_dd, dely, predict=True)
            else:
                ld = _lin_dirs(problem, st, Si_lin, Rd_lin, dely.hi if dd_mode else dely,
                               predict=True)
            alpha_min, beta_min = ld.alpha, ld.beta
        else:
            alpha_min, beta_min = one, one
        for d in dirs:
            alpha_min = torch.minimum(alpha_min, d.alpha.min())
            beta_min = torch.minimum(beta_min, d.beta.min())
        if mesh is not None:
            alpha_min, beta_min = mesh.reduce(torch.stack([alpha_min, beta_min]), "blocks", "min")

    with span("corrector"):
        # trial point + NT correction term (`find_step`,
        # src/predictor_corrector.jl:302-310)
        trXnSn_mat = zero
        RNTs = []
        for gi, (g, nt, d, X, S) in enumerate(zip(problem.groups, nts, dirs, st.X, st.S)):
            if dd2:
                # the trial trace in dd: at mu ~ 1e-18 the f64 product noise
                # would swamp it
                Xn = dd_add(X_dds[gi], dd_mul_f64(DD(d.delX, d.delX_lo), d.alpha[:, None, None]))
                Sn = dd_add(S_dds[gi], dd_mul_f64(DD(d.delS, d.delS_lo), d.beta[:, None, None]))
                t = _trace_dot_dd(Xn.hi, Sn.hi)
                t = bsum_dd(g, DD(t.hi, t.lo + ((Xn.hi * Sn.lo).sum() + (Xn.lo * Sn.hi).sum())))
                trXnSn_mat = trXnSn_mat + t.hi + t.lo
            else:
                Xn = X + d.alpha[:, None, None] * d.delX
                Sn = S + d.beta[:, None, None] * d.delS
                trXnSn_mat = trXnSn_mat + bsum(g, btrace(Xn, Sn))
            deed = nt.D[:, :, None] + nt.D[:, None, :]
            N = nt.Gi @ d.delX @ d.delS @ nt.G
            RNTs.append(-(N + N.mT) / deed)
        trXnSn = trXnSn_mat
        RNT_lin = RNT_lin_dd = None
        if nlin:
            if dd2:
                Xn_l = dd_add(Xl_dd, dd_mul_f64(ld.delX, ld.alpha))
                Sn_l = dd_add(Sl_dd, dd_mul_f64(ld.delS, ld.beta))
                t = _dd_dot(Xn_l.hi, Sn_l.hi)
                trXnSn = trXnSn + t.hi + (t.lo + (torch.dot(Xn_l.hi, Sn_l.lo)
                                                  + torch.dot(Xn_l.lo, Sn_l.hi)))
                RNT_lin_dd = dd_neg(dd_mul(dd_mul(ld.delX, ld.delS), Si_lin_dd))
                RNT_lin = RNT_lin_dd.hi
            else:
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
        if dd2:
            # the centrality target sigma*mu at dd resolution
            sig_mu_dd = dd_mul_f64(dd_div(tr_dd, dd_const(float(denom), tr_dd.hi)), sigma)

        # ---- corrector RHS (`corrector`, src/predictor_corrector.jl:183-192)
        U_dds = (None,) * ngroups
        U_lin_dd = None
        if dd_mode:
            # the reference's G[G'RdG + D - sig*mu/D - RNT]G' written as T - U
            # with U = G[sig*mu/D + RNT]G' (exact NT identities), so the same T
            # and U feed the corrector direction (`ipm/step.py:1013-1058`)
            if nt_dd:
                U_dds = tuple(_corrector_U_dd(nt, tl, RNT, sig_mu_dd)
                              for nt, tl, RNT in zip(nts, nt_tails, RNTs))
            else:
                U_dds = tuple(
                    _sandwich_dd(nt.G, torch.diag_embed(sig_mu / nt.D) + RNT, nt.G.mT)
                    for nt, RNT in zip(nts, RNTs)
                )
            h2_dd = Rp_dd
            for g, T, U in zip(problem.groups, T_dds, U_dds):
                h2_dd = dd_add(h2_dd, Aop_dd(g, T.hi, T.lo))
                h2_dd = dd_add(h2_dd, dd_neg(Aop_dd(g, U.hi, U.lo)))
            if nlin:
                if dd2:
                    # U_lin = sig_mu*Si + RNT_lin, reused verbatim in the
                    # corrector direction
                    sgv = DD(sig_mu_dd.hi.expand_as(Si_lin_dd.hi), sig_mu_dd.lo.expand_as(Si_lin_dd.hi))
                    U_lin_dd = dd_add(dd_mul(sgv, Si_lin_dd), RNT_lin_dd)
                    arg = dd_add(dd_add(dd_mul(lpw_dd, Rd_lin_dd), Xl_dd), dd_neg(U_lin_dd))
                    h2_dd = dd_add(h2_dd, _cmatvec_dd(C_lin, arg))
                else:
                    tmp = ld.delX * ld.delS * Si_lin - sig_mu * Si_lin
                    h2_dd = dd_add(h2_dd, acc_matvec(C_lin, lpw * Rd_lin + st.X_lin + tmp))
        else:
            h2 = Rp
            for g, nt, Rd, RNT in zip(problem.groups, nts, Rds, RNTs):
                GT = nt.G.mT
                inner = GT @ Rd @ nt.G + torch.diag_embed(nt.D) - torch.diag_embed(sig_mu / nt.D) - RNT
                h2 = h2 + Aop(g, nt.G @ inner @ GT)
            if nlin:
                tmp = ld.delX * ld.delS * Si_lin - sig_mu * Si_lin
                h2 = h2 + C_lin @ (lpw * Rd_lin + st.X_lin + tmp)

    with span("schur_solve"):
        dely2, cg_cor = solve(h2_dd if dd_mode else h2)

    # ---- corrector directions + final update
    with span("steplen"):
        dirs2 = tuple(
            _group_dirs(g, nt, Rd, X, dely2, predict=False, eigmin_fn=eigmin_fn, sig_mu=sig_mu,
                        RNT=RNT, T_dd=T, U_dd=U, Rd_dd=Rdd, tail=tl)
            for g, nt, Rd, X, RNT, T, U, Rdd, tl in zip(problem.groups, nts, Rds, st.X, RNTs,
                                                       T_dds, U_dds, Rd_dds, nt_tails)
        )
        if nlin:
            if dd2:
                ld2 = _lin_dirs_dd(problem, Xl_dd, Sl_dd, lpw_dd, Rd_lin_dd, dely2, predict=False,
                                   U_lin=U_lin_dd)
            else:
                ld2 = _lin_dirs(problem, st, Si_lin, Rd_lin, dely2.hi if dd_mode else dely2,
                                predict=False, sig_mu=sig_mu, RNT_lin=RNT_lin)
            amin, bmin = ld2.alpha, ld2.beta
        else:
            amin, bmin = one, one
        for d in dirs2:
            amin = torch.minimum(amin, d.alpha.min())
            bmin = torch.minimum(bmin, d.beta.min())
        if mesh is not None:
            amin, bmin = mesh.reduce(torch.stack([amin, bmin]), "blocks", "min")

    with span("update"):
        Xl_new_dd = Sl_new_dd = None
        if dd2:
            # iterate updates at dd resolution (`ipm/step.py:1138-1166`)
            y_new_dd = dd_add(y_dd, dd_mul_f64(dely2, bmin))
            X_new_dds = tuple(_dd_sym(dd_add(Xd, dd_mul_f64(DD(d.delX, d.delX_lo), amin)))
                              for Xd, d in zip(X_dds, dirs2))
            S_new_dds = tuple(_dd_sym(dd_add(Sd, dd_mul_f64(DD(d.delS, d.delS_lo), bmin)))
                              for Sd, d in zip(S_dds, dirs2))
            y_new = y_new_dd.hi
            X_new = tuple(x.hi for x in X_new_dds)
            S_new = tuple(s_.hi for s_ in S_new_dds)
            if nlin:
                Xl_new_dd = dd_add(Xl_dd, dd_mul_f64(ld2.delX, amin))
                Sl_new_dd = dd_add(Sl_dd, dd_mul_f64(ld2.delS, bmin))
            X_lin_new = Xl_new_dd.hi if nlin else None
            S_lin_new = Sl_new_dd.hi if nlin else None
        else:
            y_new = st.y + bmin * (dd_to_f64(dely2) if dd_mode else dely2)
            X_new = tuple(sym(X + amin * d.delX) for X, d in zip(st.X, dirs2))
            S_new = tuple(sym(S + bmin * d.delS) for S, d in zip(st.S, dirs2))
            X_lin_new = (st.X_lin + amin * ld2.delX) if nlin else None
            S_lin_new = (st.S_lin + bmin * ld2.delS) if nlin else None

        # ---- DIMACS errors (`check_convergence`, src/Solvers.jl:496-524).
        # The iterates are feasible by construction (steplengths from certified
        # lower bounds), so err2/err4 are zero unless the NT scaling itself was
        # regularized; then report the Gershgorin violation of the new iterate
        # ('lanczos': see `_psd_violation`).
        normb = torch.linalg.norm(problem.b)
        if dd_mode:
            by_dd = _dd_dot(problem.b, y_new)
            if dd2:
                s2 = two_sum(by_dd.hi, torch.dot(problem.b, y_new_dd.lo))
                by_dd = DD(s2.hi, s2.lo + by_dd.lo)
            by = dd_to_f64(by_dd)
            trCX_dd = _dd0(zero)
        else:
            by = torch.dot(problem.b, y_new)
        err1 = torch.linalg.norm(Rp) / (1.0 + normb)
        err2, err3, err4, err6, trCX = zero, zero, zero, zero, zero
        for gi, (g, X, S, Rd) in enumerate(zip(problem.groups, X_new, S_new, Rds)):
            normC = torch.sqrt((g.C**2).sum((-1, -2)))  # [nb]
            viol = _psd_violation(torch.cat([X, S], dim=0), nt_suspect, cert_mode)
            violX, violS = viol[: X.shape[0]], viol[X.shape[0] :]
            CX = (g.C * X).sum((-1, -2))
            # the group's block sums, completed over 'blocks' in one all-reduce
            e234c = bsum(g, torch.stack([
                (violX / (1.0 + normb)).sum(),
                (torch.sqrt((Rd**2).sum((-1, -2))) / (1.0 + normC)).sum(),
                (violS / (1.0 + normC)).sum(),
                CX.sum(),
            ]))
            err2 = err2 + e234c[0]
            err3 = err3 + e234c[1]
            err4 = err4 + e234c[2]
            trCX = trCX + e234c[3]
            if dd_mode:
                t = _trace_dot_dd(g.C, X)
                if dd2:
                    s2 = two_sum(t.hi, (g.C * X_new_dds[gi].lo).sum())
                    t = DD(s2.hi, s2.lo + t.lo)
                trCX_dd = dd_add(trCX_dd, bsum_dd(g, t))
            if dd2:
                # per-block <S, X> in dd: near the floor the f64 product noise
                # exceeds the true barrier value
                Xd2, Sd2 = X_new_dds[gi], S_new_dds[gi]
                nb_ = X.shape[0]
                p = two_prod(Sd2.hi.reshape(nb_, -1), Xd2.hi.reshape(nb_, -1))
                t = dd_sum(p, axis=-1)  # [nb]
                cross = (Sd2.hi * Xd2.lo + Sd2.lo * Xd2.hi).reshape(nb_, -1).sum(-1)
                SX = t.hi + (t.lo + cross)
            else:
                SX = (S * X).sum((-1, -2))
            err6 = err6 + bsum(g, (SX / (1.0 + CX.abs() + by.abs())).sum())
        if nlin:
            dX = torch.dot(problem.d_lin, X_lin_new)
            normd = torch.linalg.norm(problem.d_lin)
            err2 = err2 + (-X_lin_new.min()).clamp_min(0.0) / (1.0 + normb)
            err3 = err3 + torch.linalg.norm(Rd_lin) / (1.0 + normd)
            err4 = err4 + (-S_lin_new.min()).clamp_min(0.0) / (1.0 + normd)
            if dd_mode:
                ddX = _dd_dot(problem.d_lin, X_lin_new)
                if dd2:
                    s2 = two_sum(ddX.hi, torch.dot(problem.d_lin, Xl_new_dd.lo))
                    ddX = DD(s2.hi, s2.lo + ddX.lo)
                gap = dd_to_f64(dd_add(dd_add(trCX_dd, ddX), dd_neg(by_dd)))
            else:
                gap = trCX + dX - by
            err5 = gap / (1.0 + trCX.abs() + by.abs())
            if dd2:
                t = _dd_dot(Sl_new_dd.hi, Xl_new_dd.hi)
                cross = torch.dot(Sl_new_dd.hi, Xl_new_dd.lo) + torch.dot(Sl_new_dd.lo, Xl_new_dd.hi)
                SXl = t.hi + (t.lo + cross)
            else:
                SXl = torch.dot(S_lin_new, X_lin_new)
            err6 = err6 + SXl / (1.0 + dX.abs() + by.abs())
        else:
            gap = dd_to_f64(dd_add(trCX_dd, dd_neg(by_dd))) if dd_mode else trCX - by
            err5 = gap / (1.0 + trCX.abs() + by.abs())

        dimacs = err2 + err3 + err4 + err5.abs() + err6
        if problem.nlmi > 0:
            dimacs = dimacs + err1

        new_state = IPMState(X=X_new, S=S_new, y=y_new, X_lin=X_lin_new, S_lin=S_lin_new,
                             sigma=sigma)
        if dd2:
            new_state = IPMState(
                X=X_new, S=S_new, y=y_new, X_lin=X_lin_new, S_lin=S_lin_new, sigma=sigma,
                X_lo=tuple(x.lo for x in X_new_dds), S_lo=tuple(s_.lo for s_ in S_new_dds),
                y_lo=y_new_dd.lo,
                X_lin_lo=None if Xl_new_dd is None else Xl_new_dd.lo,
                S_lin_lo=None if Sl_new_dd is None else Sl_new_dd.lo,
            )
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
