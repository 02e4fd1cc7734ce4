"""Small batched linear-algebra building blocks. Port of
`loraine_tpu/ops/linalg.py` (`sym`, `btrace`, `chol_reg`, `tri_solve`,
`cho_solve`, `tri_inv`, `cho_solve_inv`).

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
