"""Per-phase timing diagnostics. Port of `loraine_tpu/utils/diagnostics.py`.

Each phase of one IPM iteration runs standalone on a representative iterate
(reached by a few warm-up steps) and is timed after a warm-up call: with
CUDA events on the card, with `time.perf_counter` on the CPU. Phase names
are the JAX package's, which mirror the reference's TimerOutputs sections
(`prepare_W` `src/prepare_W.jl:37-46`, `BBBB` `src/makeBBBB.jl:86-98`,
`backslash`/Cholesky `src/predictor_corrector.jl:55-97`, `find_step_A..D`
`src/predictor_corrector.jl:251-285`, convergence `src/Solvers.jl:496-568`;
printed by the reference when `timing > 0`, `src/Loraine.jl:88-90`). The
whole-step row keeps the JAX name "full fused step", though the port's step
is eager PyTorch and fuses nothing: it is the ground truth the phase rows
attribute.

The options are resolved first (`Options.resolved`), so every row runs
what the solve runs. The kernels of the rows: the NT row seeds
`eigh_mixed` with B1 under ``eigh_backend`` 'pallas' (what 'auto'
resolves to); "find_step spectral" times the step's own bound function
(`ipm/step.py:_bound_fns`) on the predictor's scaleS: B2
(`eig_bounds_jacobi`) under ``step_eig`` 'pallas' ('auto' in the port on
every device; in the JAX package on the TPU only) and under 'exact' with
``eigh_backend`` 'pallas'; on kit=1's materialized route "CG solve (ff
kernel, tol 1e-7)" runs B3 where ``cg_kernel`` resolves to 'ff' (on a
card; the JAX package adds the row on the TPU only).

Wired into the solver: ``timing=2`` prints this breakdown after the solve
(`Solver.solve`), and the CLI exposes ``--phases``.

    from loraine_tpu_torch.utils.diagnostics import profile_phases
    times = profile_phases(problem, options)   # dict of seconds
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from ..config import Options
from ..ops.linalg import chol_reg, cho_solve_inv, sym, tri_inv
from ..ops.nt_scaling import nt_scale
from ..ops.schur import Aadj, Aop, lp_weight, schur_group, schur_lp

__all__ = ["profile_phases", "format_phases"]


def _timed(fn, *args, repeats: int = 5, cuda: bool = False) -> float:
    """Seconds per call of ``fn(*args)``: one warm-up call, then the better
    of two passes of ``repeats`` calls, by CUDA events when ``cuda``."""
    fn(*args)
    best = float("inf")
    for _ in range(2):
        if cuda:
            torch.cuda.synchronize()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(repeats):
                fn(*args)
            t1.record()
            torch.cuda.synchronize()
            sec = t0.elapsed_time(t1) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(repeats):
                fn(*args)
            sec = time.perf_counter() - t0
        best = min(best, sec / repeats)
    return best


def profile_phases(
    problem, options=None, repeats: int = 5, iters: int = 3
) -> Dict[str, float]:
    """Time each IPM phase standalone at a representative iterate (reached by
    ``iters`` warm-up steps) on the problem's device. Returns {phase name:
    seconds}. The 'full fused step' row (one whole eager step) is the ground
    truth; phase rows attribute it."""
    from ..ipm.initial import initial_point
    from ..ipm.step import _bound_fns, step

    opts = options if isinstance(options, Options) else Options.from_dict(options)
    opts = opts.validated().resolved(problem, problem.device)
    precond = opts.preconditioner if opts.kit else None
    st = initial_point(problem, opts)
    for _ in range(iters):
        st, _stats = step(problem, st, opts, opts.tol_cg, precond)
    dtype, device = problem.b.dtype, problem.device
    out: Dict[str, float] = {}

    def timed(fn, *args):
        return _timed(fn, *args, repeats=repeats, cuda=device.type == "cuda")

    def all_nt(X, S):
        return tuple(nt_scale(x, s, method=opts.nt_method, eigh_backend=opts.eigh_backend,
                              chol_backend=opts.chol_backend)
                     for x, s in zip(X, S))

    out["prepare_W (NT scaling)"] = timed(all_nt, st.X, st.S)
    nts = all_nt(st.X, st.S)

    def resid(X, y):
        Rp = problem.b
        for g, Xg in zip(problem.groups, X):
            Rp = Rp - Aop(g, Xg)
        Rds = tuple(sym(g.C - S - Aadj(g, y)) for g, S in zip(problem.groups, st.S))
        h = Rp
        for g, nt, Rd, S in zip(problem.groups, nts, Rds, st.S):
            h = h + Aop(g, nt.W @ (Rd + S) @ nt.W)
        return Rp, Rds, h

    out["residuals + RHS (makeRHS)"] = timed(resid, st.X, st.y)
    Rp, Rds, h = resid(st.X, st.y)
    lpw = lp_weight(st.X_lin, 1.0 / st.S_lin) if problem.nlin else None

    def schur(nts):
        H = torch.zeros((problem.n, problem.n), dtype=dtype, device=device)
        for g, nt in zip(problem.groups, nts):
            H = H + schur_group(g, nt.W, nt.G, opts.gemm_backend)
        if problem.nlin:
            H = H + schur_lp(problem.C_lin, lpw)
        return sym(H)

    if opts.kit == 0:
        out["Schur assembly (BBBB)"] = timed(schur, nts)
        H = schur(nts)

        def hchol(H):
            return tri_inv(chol_reg(H, 1e-4, 1000, backend=opts.chol_backend).L)

        out["H Cholesky + tri_inv"] = timed(hchol, H)
        Li = hchol(H)

        def solve4(Li, h):
            x = h
            for _ in range(4):
                x = cho_solve_inv(Li, x)
            return x

        out["4x triangular solves (GEMV)"] = timed(solve4, Li, h)
    else:
        # kit=1: the materialized Schur operator, the H_alpha preparation and
        # the CG kernel, as the step's materialized route runs them
        from ..ops.pcg import pcg_kernel_ff
        from ..ops.precond import prep_alpha

        mat_cg = opts.cg_materialize == "always"
        if mat_cg:
            out["Schur materialize (CG operator)"] = timed(schur, nts)
            Hcg = schur(nts)
        if opts.preconditioner in (1, 4):
            def palpha(nts):
                pa = prep_alpha(problem, nts, lpw, opts.erank, opts.aamat, opts.eigh_backend,
                                materialize=mat_cg)
                return pa.Mli if mat_cg else pa.diag_scalar

            out["precond prep (H_alpha)"] = timed(palpha, nts)
        if mat_cg and opts.cg_kernel == "ff":
            Mli = prep_alpha(problem, nts, lpw, opts.erank, opts.aamat, opts.eigh_backend,
                             materialize=True).Mli

            def cgsolve(Hcg, Mli, rhs):
                return pcg_kernel_ff(Hcg, Mli, rhs, 1e-7, opts.cg_maxiter)[0]

            out["CG solve (ff kernel, tol 1e-7)"] = timed(cgsolve, Hcg, Mli, h)

    # steplength phase: the predictor's scaled-direction bounds by the
    # step's own bound functions (find_step_A..D): (lambda_min, lambda_max)
    # of scaleS under 'pallas' (the predictor identity), else lambda_min of
    # [scaleX; scaleS] with scaleX = -I - scaleS
    eigmin_fn, eigrange_fn, _ = _bound_fns(opts)
    for gi, nt in enumerate(nts):
        def steplen(delS, nt=nt):
            delSb = nt.G.mT @ delS @ nt.G
            scaleS = sym(nt.DDsi[:, :, None] * delSb * nt.DDsi[:, None, :])
            if eigrange_fn is not None:
                return eigrange_fn(scaleS)
            eye = torch.eye(scaleS.shape[-1], dtype=dtype, device=device)
            return eigmin_fn(torch.cat([-eye - scaleS, scaleS], dim=0))

        out[f"find_step spectral, group{gi} (predictor)"] = timed(steplen, Rds[gi])

    # DIMACS errors (check_convergence)
    def dimacs(X, S, y):
        err = torch.zeros((), dtype=dtype, device=device)
        for g, Xg, Sg in zip(problem.groups, X, S):
            L = torch.linalg.cholesky_ex(torch.cat([Xg, Sg], dim=0))[0]
            err = err + torch.isnan(L).sum().to(dtype)
            err = err + torch.einsum("bpq,bpq->b", Sg, Xg).sum()
            err = err + torch.sqrt(((g.C - Sg) ** 2).sum((-1, -2))).sum()
        return err + torch.dot(problem.b, y)

    out["DIMACS errors (check_convergence)"] = timed(dimacs, st.X, st.S, st.y)

    def whole(st):
        return step(problem, st, opts, opts.tol_cg, precond)[0].y

    out["full fused step"] = timed(whole, st)
    return out


def format_phases(times: Dict[str, float], device: str = "cuda") -> str:
    """Render the phase table (the reference prints a TimerOutputs tree when
    timing > 0; this is the equivalent surface). ``device``: the device type
    the times were taken on, named in the header ('cuda': CUDA events on
    the card; 'cpu': the host clock)."""
    total = times.get("full fused step", None)
    width = max(len(k) for k in times)
    how = "device times, CUDA events" if device == "cuda" else "CPU times, host clock"
    lines = [f" per-phase {how} (standalone phases; 'full fused step' is ground truth)"]
    for k, v in times.items():
        pct = f" {100.0 * v / total:5.1f}%" if total and k != "full fused step" else ""
        lines.append(f"   {k:<{width}} {v * 1e3:9.2f} ms{pct}")
    return "\n".join(lines)
