"""Low-rank preconditioners H_alpha / H_beta for the CG path. Port of
`loraine_tpu/ops/precond.py` (dense, rank-1 and sparse data, LP cone).

Math (reference `docs/src/low-rank_solutions.md`, `src/Solvers.jl:616-904`):
with the NT scaling point split W = W_0 + U U^T (U spanning the top-``erank``
eigenspace), the Schur operator is approximated by

    H_alpha = AAAATtau + V V^T,  V = A^T (U (x) Z),  Z Z^T = 2 W_0 + U U^T
    H_beta  = AAAATtau           (its diagonal only)

where AAAATtau = (sum_i ttau_i^2) I + C_lin diag(x_lin / s_lin) C_lin^T and
ttau_i is a scalar surrogate for the tail spectrum of W_i (``aamat``).
H_alpha^{-1} is applied with Sherman-Morrison-Woodbury through the small
matrix V^T AAAATtau^{-1} V + I (`AlphaPrecond.apply_with`), or, materialized,
as the inverse Cholesky factor of the n x n matrix AAAATtau + V V^T
(`AlphaPrecondDense`).

On a sharded problem (`parallel/mesh.py`) each rank computes the W
eigendecompositions and V's entries of its own blocks and rows; the sums
over blocks are all-reduced and V is gathered whole, so the
preconditioner itself (Mli, or the SMW factor) is replicated.

The eigendecompositions of W follow ``eigh_backend`` as in the JAX package's
`_eigh` (`loraine_tpu/ops/precond.py:37-43`): 'jacobi' is `eigh_jacobi`,
'mixed' `eigh_mixed` with the library's f32 seed, and 'xla' and 'pallas'
(so 'auto' too) the library's f64 `torch.linalg.eigh`: there the resolved
'pallas' falls through to the library call, not to the Jacobi kernel.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..problem import SDPProblem
from .eigh import eigh_backend_for, eigh_jacobi, eigh_mixed
from .linalg import chol_reg, cho_solve, eigh_or_nan, sym, tri_inv
from .nt_scaling import NTScaling
from .schur import Aadj, Aop, bsum, gather_blocks, gather_rows

__all__ = [
    "BetaPrecond", "AlphaPrecond", "AlphaPrecondDense", "prep_beta",
    "prep_alpha",
]


def _eigh(M: torch.Tensor, backend: str) -> Tuple[torch.Tensor, torch.Tensor]:
    resolved = eigh_backend_for(backend, M.shape[-1])
    if resolved == "jacobi":
        return eigh_jacobi(M)
    if resolved == "mixed":
        return eigh_mixed(M)
    return eigh_or_nan(M)


def _ttau(lam_s: torch.Tensor, aamat: int) -> torch.Tensor:
    """Tail-spectrum surrogate per block: min, or (min + mean) / 2, of the
    tail eigenvalues (`src/Solvers.jl:646-650,715-719`). lam_s [nb, m-k]
    ascending."""
    lam_min = lam_s[:, 0]
    if aamat == 0:
        return lam_min
    return (lam_min + lam_s.mean(1)) / 2.0 - 1.0e-14


class BetaPrecond(NamedTuple):
    diag: torch.Tensor  # [n]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x / self.diag


def prep_beta(
    problem: SDPProblem,
    nts: Tuple[NTScaling, ...],
    lpw: Optional[torch.Tensor],
    erank: int,
    aamat: int,
    eigh_backend: str = "auto",
) -> BetaPrecond:
    s = torch.zeros((), dtype=problem.b.dtype, device=problem.device)
    for g, nt in zip(problem.groups, nts):
        k = min(erank, g.m - 1)
        lam, _ = _eigh(nt.W, eigh_backend)  # [nb, m] ascending
        s = s + bsum(g, (_ttau(lam[:, : g.m - k], aamat) ** 2).sum())
    diag = torch.ones_like(problem.b) * s
    if problem.nlin > 0:
        diag = diag + problem.C_lin**2 @ lpw
    return BetaPrecond(diag=diag)


class AlphaPrecond(NamedTuple):
    U: Tuple[torch.Tensor, ...]  # per group [nb, m, k]
    Z: Tuple[torch.Tensor, ...]  # per group [nb, m, m] lower Cholesky of 2W0+UU^T
    cholS: torch.Tensor  # [sizeS, sizeS] lower factor of the SMW matrix + I
    diag_scalar: torch.Tensor  # sum_i ttau_i^2
    lp_chol: Optional[torch.Tensor]  # lower factor of AAAATtau when nlin > 0
    groups_meta: Tuple[Tuple[int, int, int], ...]  # (nb, k, m) per group, nb whole

    def _solve_tau(self, x: torch.Tensor) -> torch.Tensor:
        if self.lp_chol is not None:
            return cho_solve(self.lp_chol, x)
        return x / self.diag_scalar

    def apply_with(self, problem: SDPProblem, x: torch.Tensor) -> torch.Tensor:
        """SMW apply: AAAATtau^{-1} x minus the low-rank correction
        (`src/Solvers.jl:866-904`)."""
        v = self._solve_tau(x)
        segs: List[torch.Tensor] = []
        for g, U, Z in zip(problem.groups, self.U, self.Z):
            M22 = Aadj(g, v)  # [nb, m, m], symmetric
            seg = torch.einsum("bpq,bpr,brl->blq", Z, M22, U)
            segs.append(gather_blocks(g, seg).reshape(-1))
        y = cho_solve(self.cholS, torch.cat(segs))
        yy2 = torch.zeros_like(x)
        off = 0
        for g, U, Z, (nb, k, m) in zip(problem.groups, self.U, self.Z, self.groups_meta):
            seg = y[off : off + nb * k * m].reshape(nb, k, m)
            off += nb * k * m
            if g.shard is not None and g.shard.split_blocks:
                seg = seg[g.shard.blocks[0] : g.shard.blocks[1]]
            Mrec = torch.einsum("bpq,blq,brl->bpr", Z, seg, U)  # Z Y U^T
            yy2 = yy2 + Aop(g, sym(Mrec))
        return v - self._solve_tau(yy2)


class AlphaPrecondDense(NamedTuple):
    """H_alpha materialized: M = AAAATtau + t t^T, applied as two GEMVs against
    the inverse Cholesky factor. Same operator as `AlphaPrecond` up to
    rounding."""

    Mli: torch.Tensor  # inv(L) for M = L L^T

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.Mli.mT @ (self.Mli @ x)


def prep_alpha(
    problem: SDPProblem,
    nts: Tuple[NTScaling, ...],
    lpw: Optional[torch.Tensor],
    erank: int,
    aamat: int,
    eigh_backend: str = "auto",
    materialize: bool = False,
):
    """H_alpha for the current NT scaling: `AlphaPrecondDense` when
    ``materialize`` (the materialized CG route), else `AlphaPrecond`."""
    n = problem.n
    s = torch.zeros((), dtype=problem.b.dtype, device=problem.device)
    Us: List[torch.Tensor] = []
    Zs: List[torch.Tensor] = []
    meta: List[Tuple[int, int, int]] = []
    for g, nt in zip(problem.groups, nts):
        m = g.m
        k = min(erank, m - 1)
        lam, V = _eigh(nt.W, eigh_backend)  # ascending
        lam_s, lam_l = lam[:, : m - k], lam[:, m - k :]
        tt = _ttau(lam_s, aamat)  # [nb]
        U = V[:, :, m - k :] * torch.sqrt((lam_l - tt[:, None]).clamp_min(0.0))[:, None, :]
        # 2 W_0 + U U^T = V diag([2 lam_s, lam_l + ttau]) V^T
        dz = torch.cat([2.0 * lam_s, lam_l + tt[:, None]], dim=1)
        Z = chol_reg(sym((V * dz[:, None, :]) @ V.mT), 1e-10, 50).L
        Us.append(U)
        Zs.append(Z)
        meta.append((len(g.orig_indices), k, m))
        s = s + bsum(g, (tt**2).sum())

    # AAAATtau = s I + C_lin diag(lpw) C_lin^T (dense when nlin > 0)
    lp_tau = None
    if problem.nlin > 0:
        eye = torch.eye(n, dtype=s.dtype, device=s.device)
        lp_tau = s * eye + (problem.C_lin * lpw[None, :]) @ problem.C_lin.mT

    # V = A^T (U (x) Z) as t[j, (b, l, q)] = (Z_b^T A_j^{(b)} U_b)[q, l]
    tcols: List[torch.Tensor] = []
    for g, U, Z in zip(problem.groups, Us, Zs):
        if g.is_rank1:
            ZB = torch.einsum("bpq,bjp->bjq", Z, g.B)  # Z^T b_j
            UB = torch.einsum("bpl,bjp->bjl", U, g.B)  # U^T b_j
            t_g = torch.einsum("bj,bjl,bjq->jblq", g.Bsgn, UB, ZB)
        elif g.is_sparse:
            # (Z^T A_j U)[q, l] = sum_t v_t Z[r_t, q] U[c_t, l]
            bidx = torch.arange(g.nb, device=Z.device)[:, None, None]
            Zr, Uc = Z[bidx, g.Arows], U[bidx, g.Acols]  # [nb, n, s, m], [nb, n, s, k]
            t_g = torch.einsum("bjt,bjtq,bjtl->jblq", g.Avals, Zr, Uc)
        else:
            AU = torch.einsum("bjpr,brl->bjpl", g.A, U)
            t_g = torch.einsum("bpq,bjpl->jblq", Z, AU)
        # V whole on every rank: its rows gathered, then its blocks
        tcols.append(gather_blocks(g, gather_rows(g, t_g), 1).reshape(n, -1))
    t = torch.cat(tcols, dim=1)  # [n, sizeS]
    if materialize:
        M = s * torch.eye(n, dtype=t.dtype, device=t.device) if lp_tau is None else lp_tau
        M = M + t @ t.mT
        return AlphaPrecondDense(Mli=tri_inv(chol_reg(sym(M), 1e-10, 50).L))
    lp_chol = None if lp_tau is None else chol_reg(lp_tau, 1e-10, 50).L
    tau_t = t / s if lp_chol is None else cho_solve(lp_chol, t)
    Ssmw = sym(t.mT @ tau_t) + torch.eye(t.shape[1], dtype=t.dtype, device=t.device)
    return AlphaPrecond(
        U=tuple(Us),
        Z=tuple(Zs),
        cholS=chol_reg(Ssmw, 1e-10, 50).L,
        diag_scalar=s,
        lp_chol=lp_chol,
        groups_meta=tuple(meta),
    )
