"""Small batched linear-algebra building blocks. Port of
`loraine_tpu/ops/linalg.py` (`sym`, `btrace`, `chol_reg`, `tri_solve`,
`cho_solve`, `tri_inv`, `cho_solve_inv`, `eigmin`, `eigmin_chol`).

The Cholesky factorization and triangular solves are f64 library calls
(cuSOLVER / cuBLAS on the card, LAPACK on the CPU): the JAX package also
computes them outside any Pallas kernel. The blocked variants the JAX
package built for the TPU (`chol_blocked`, the doubling `tri_inv`) are not
carried over; the library routines compute the same factors to rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "sym",
    "btrace",
    "chol_reg",
    "CholResult",
    "tri_solve",
    "cho_solve",
    "tri_inv",
    "cho_solve_inv",
    "eigmin",
    "eigmin_chol",
    "eigh_or_nan",
    "svd_or_nan",
]


def sym(M: torch.Tensor) -> torch.Tensor:
    """Symmetrize on the last two axes (the reference's `mat`,
    `src/kron_etc.jl:13-18`)."""
    return (M + M.mT) / 2


def btrace(X: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """sum_b <X_b, S_b> over the leading batch axis (`src/kron_etc.jl:21-28`)."""
    return torch.sum(X * S)


class CholResult(NamedTuple):
    L: torch.Tensor  # lower factor(s); NaN where a factorization failed
    shifts: int  # number of eps*I shift rounds applied
    ok: bool  # all factorizations succeeded


def chol_reg(M: torch.Tensor, eps: float, max_tries: int = 1000) -> CholResult:
    """Cholesky with bounded diagonal-shift regularization
    (`loraine_tpu/ops/linalg.py:chol_reg`, reference `try_cholesky` and the
    Schur regularization loop, `src/prepare_W.jl:5-26`,
    `src/predictor_corrector.jl:55-97`).

    Failing batch elements get ``eps * I`` added repeatedly (up to
    ``max_tries`` rounds) until positive definite; elements that succeed are
    never shifted. A failure is ``info != 0`` from `cholesky_ex` or a NaN in
    the factor. Failed factors come back as NaN, as in the JAX package, so a
    give-up propagates into the step's status. One host sync per round.
    """
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)

    def attempt(Mc):
        L, info = torch.linalg.cholesky_ex(Mc)
        bad = (info != 0) | torch.isnan(L).any(dim=(-1, -2))
        return L, bad

    L, bad = attempt(M)
    shifts = 0
    Mc = M
    while shifts < max_tries and bool(bad.any()):
        Mc = Mc + eps * eye * bad[..., None, None].to(M.dtype)
        L, bad = attempt(Mc)
        shifts += 1
    ok = not bool(bad.any())
    if not ok:
        L = torch.where(bad[..., None, None], torch.full_like(L, float("nan")), L)
    return CholResult(L=L, shifts=shifts, ok=ok)


def tri_solve(L: torch.Tensor, B: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """Solve L X = B (or L^T X = B) with lower-triangular L; batched."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b given the lower Cholesky factor; batched."""
    if b.ndim == L.ndim - 1:
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.cholesky_solve(b, L)


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a lower-triangular matrix (one multi-RHS
    triangular solve). The step solves against the same factor four times
    per iteration, and each solve then costs two GEMVs; the step's one
    refinement pass absorbs the u*cond-class inversion error."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def cho_solve_inv(Li: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b given Li = inv(L): two GEMVs/GEMMs."""
    if b.ndim == Li.ndim - 1:
        y = (Li @ b[..., None])[..., 0]
        return (Li.mT @ y[..., None])[..., 0]
    return Li.mT @ (Li @ b)


def eigh_or_nan(M: torch.Tensor):
    """The library's `eigh` (LAPACK / cuSOLVER), with NaN eigenpairs where
    it does not converge (a NaN or badly scaled input, as f32 iterates reach
    late in a run), as `jnp.linalg.eigh` returns them; torch raises
    instead. The NaNs then end the solve with status 3 (non-finite DIMACS),
    as in the JAX package."""
    try:
        return torch.linalg.eigh(M)
    except torch.linalg.LinAlgError:
        nan = torch.full_like(M, float("nan"))
        return nan[..., 0], nan


def svd_or_nan(M: torch.Tensor):
    """The library's `svd`, NaN where it does not converge (see
    `eigh_or_nan`)."""
    try:
        return torch.linalg.svd(M)
    except torch.linalg.LinAlgError:
        nan = torch.full_like(M, float("nan"))
        return nan, nan[..., 0], nan


def eigmin(M: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvalue(s) of symmetric M (the library's `eigvalsh`, NaN
    where it does not converge); batched over leading axes."""
    try:
        return torch.linalg.eigvalsh(M)[..., 0]
    except torch.linalg.LinAlgError:
        return torch.full_like(M[..., 0, 0], float("nan"))


def eigmin_chol(M: torch.Tensor, iters: int = 45) -> torch.Tensor:
    """Lower bound on the smallest eigenvalue by Cholesky bisection
    (`loraine_tpu/ops/linalg.py:272-300`): chol(M - t I) succeeds iff
    lambda_min > t. Starts from the Gershgorin bracket [-B, B] and returns
    the bracket's lower end after ``iters`` halvings (width 2B 2^-iters), so
    steplengths derived from it are never longer than the exact ones.

    A factorization counts as failed where `cholesky_ex` reports info != 0
    (LAPACK / cuSOLVER potrf: a pivot not positive, NaN included), which is
    where the JAX package's `jnp.linalg.cholesky` returns NaN. No host sync
    per step."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    B = M.abs().sum(-1).amax(-1)  # Gershgorin outer radius
    lo, hi = -B, B
    for _ in range(iters):
        mid = (lo + hi) / 2.0
        _, info = torch.linalg.cholesky_ex(M - mid[..., None, None] * eye)
        ok = info == 0  # PD: lambda_min > mid
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return lo
