"""Small batched linear-algebra building blocks. Port of
`loraine_tpu/ops/linalg.py` (`sym`, `btrace`, `chol_reg`, `tri_solve`,
`cho_solve`, `tri_inv`, `cho_solve_inv`, `eigmin`, `eigmin_chol`).

The Cholesky factorization and triangular solves are f64 library calls
(cuSOLVER / cuBLAS on the card, LAPACK on the CPU): the JAX package also
computes them outside any Pallas kernel. On one device the library
routines replace the JAX package's TPU-shaped blocked variants and compute
the same factors to rounding; ``chol_backend='mixed'`` factors with the
f32-panel Cholesky of `ops/mixed_chol.py` instead.

With a mesh whose 'schur' axis splits the rows (``mesh=``), `chol_blocked`,
`tri_inv` and `cho_solve_inv` work on row-sharded matrices: the JAX
package's right-looking panel loop (`loraine_tpu/ops/linalg.py:39-98`),
with one panel all-reduce per step and every O(n^3) GEMM on the rank's own
rows, so H is never gathered whole. They are f64 library GEMMs and
triangular solves, as in the JAX package, where they are plain `jnp`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "sym",
    "btrace",
    "chol_blocked",
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


def _chol_nan(D: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of D, NaN on and below the
    diagonal where it fails, as `jnp.linalg.cholesky` returns it."""
    L, info = torch.linalg.cholesky_ex(D)
    bad = (info != 0) | torch.isnan(L).flatten(-2).any(-1)
    return torch.where(bad[..., None, None], torch.full_like(L, float("nan")).tril(), L)


def chol_blocked(M_rows: torch.Tensor, mesh, base: int = 128) -> torch.Tensor:
    """Lower Cholesky factor of a symmetric n x n matrix whose rows are
    sharded over ``mesh``'s 'schur' axis: ``M_rows`` is this rank's rows
    [r0, r1) (`mesh.split(n, 'schur')`), and so is the result. Only the
    lower triangle is read.

    The right-looking panel loop of `loraine_tpu/ops/linalg.py:39-98`. Per
    panel of ``base`` columns k:k+b, the panel column T[k:, k:k+b] is
    gathered (one all-reduce), every rank factors D = T[k:k+b, k:k+b] and
    solves L_rk = R L_kk^{-T} (both O(n b^2)), keeps its own rows of the
    panel, and applies the rank-b trailing update T -= L_rk L_rk^T to its
    own rows (the O(n^3) bulk, split over the ranks).

    NaN semantics of the JAX package: an indefinite diagonal block gives an
    L_kk that is NaN on and below its diagonal, and the NaN runs through
    every later panel."""
    n = M_rows.shape[-1]
    r0, r1, _ = mesh.split(n, "schur")
    if M_rows.shape[0] != r1 - r0:
        raise ValueError(f"M_rows has {M_rows.shape[0]} rows, this rank holds [{r0}, {r1})")
    T = M_rows.clone()
    L = torch.zeros_like(M_rows)
    for k in range(0, n, base):
        b = min(base, n - k)
        lo = max(r0, k)  # first local row at or below the panel
        part = T.new_zeros((n - k, b))
        if lo < r1:
            part[lo - k : r1 - k] = T[lo - r0 :, k : k + b]
        panel = mesh.reduce(part, "schur")
        Ld = _chol_nan(panel[:b])
        col = panel.clone()
        col[:b] = Ld
        if k + b < n:
            col[b:] = torch.linalg.solve_triangular(Ld, panel[b:].mT, upper=False).mT
        if lo < r1:
            L[lo - r0 :, k : k + b] = col[lo - k : r1 - k]
        up = max(r0, k + b)  # local rows of the trailing matrix
        if up < r1 and k + b < n:
            T[up - r0 :, k + b :] -= col[up - k : r1 - k] @ col[b:].mT
    return L


def chol_reg(M: torch.Tensor, eps: float, max_tries: int = 1000, backend: str = "f64",
             mesh=None) -> CholResult:
    """Cholesky with bounded diagonal-shift regularization
    (`loraine_tpu/ops/linalg.py:chol_reg`, reference `try_cholesky` and the
    Schur regularization loop, `src/prepare_W.jl:5-26`,
    `src/predictor_corrector.jl:55-97`).

    Failing batch elements get ``eps * I`` added repeatedly (up to
    ``max_tries`` rounds) until positive definite; elements that succeed are
    never shifted. A failure is ``info != 0`` from `cholesky_ex` or a NaN in
    the factor. Failed factors come back as NaN, as in the JAX package, so a
    give-up propagates into the step's status. One host sync per round.

    ``backend`` (the resolved ``chol_backend``): 'f64' is the library's f64
    factorization, 'mixed' the f32-panel factorization of
    `ops/mixed_chol.py` (f64 fallback per panel, the same NaN semantics).

    ``mesh``: M is one n x n matrix whose rows [r0, r1) this rank holds
    (`chol_blocked`, f64 whatever ``backend`` says, as
    `loraine_tpu/ops/linalg.py:139-143`); the shift goes onto the local
    rows' diagonal, and the failure flag is all-reduced over 'schur', so
    every rank shifts the same number of times.
    """
    if mesh is not None:
        return _chol_reg_rows(M, eps, max_tries, mesh)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    mixed = backend == "mixed"

    def attempt(Mc):
        if mixed:
            from .mixed_chol import chol_mixed_blocked

            L = chol_mixed_blocked(Mc)
            return L, torch.isnan(L).any(dim=(-1, -2))
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


def _chol_reg_rows(M: torch.Tensor, eps: float, max_tries: int, mesh) -> CholResult:
    n = M.shape[-1]
    r0, r1, _ = mesh.split(n, "schur")
    shift = torch.zeros_like(M)
    shift[:, r0:r1] = eps * torch.eye(r1 - r0, dtype=M.dtype, device=M.device)

    def attempt(Mc):
        L = chol_blocked(Mc, mesh)
        return L, bool(mesh.reduce(torch.isnan(L).any(), "schur", "max"))

    L, bad = attempt(M)
    shifts = 0
    Mc = M
    while shifts < max_tries and bad:
        Mc = Mc + shift
        L, bad = attempt(Mc)
        shifts += 1
    return CholResult(L=L, shifts=shifts, ok=not bad)


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


def tri_inv(L: torch.Tensor, mesh=None, base: int = 128) -> torch.Tensor:
    """Explicit inverse of a lower-triangular matrix (one multi-RHS
    triangular solve). The step solves against the same factor four times
    per iteration, and each solve then costs two GEMVs; the step's one
    refinement pass absorbs the u*cond-class inversion error.

    ``mesh``: L holds this rank's rows [r0, r1) of an n x n factor
    (`chol_blocked`), and so does the result: a blocked forward
    substitution L Li = I. Per panel k:k+b the panel's rows of the
    right-hand side and L_kk are gathered (one all-reduce of b x (k+2b)),
    every rank solves Li_k = L_kk^{-1} B_k, and each updates its own rows
    below, B_i -= L_ik Li_k."""
    if mesh is not None:
        return _tri_inv_rows(L, mesh, base)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _tri_inv_rows(L: torch.Tensor, mesh, base: int) -> torch.Tensor:
    n = L.shape[-1]
    r0, r1, _ = mesh.split(n, "schur")
    Bm = torch.zeros_like(L)  # right-hand side rows, I to start
    Bm[:, r0:r1] = torch.eye(r1 - r0, dtype=L.dtype, device=L.device)
    Li = torch.zeros_like(L)
    for k in range(0, n, base):
        b = min(base, n - k)
        part = L.new_zeros((b, k + 2 * b))  # [B_k[:, :k+b] | L_kk]
        lo, hi = max(r0, k), min(r1, k + b)
        if lo < hi:
            part[lo - k : hi - k, : k + b] = Bm[lo - r0 : hi - r0, : k + b]
            part[lo - k : hi - k, k + b :] = L[lo - r0 : hi - r0, k : k + b]
        part = mesh.reduce(part, "schur")
        Lik = torch.linalg.solve_triangular(part[:, k + b :], part[:, : k + b], upper=False)
        if lo < hi:
            Li[lo - r0 : hi - r0, : k + b] = Lik[lo - k : hi - k]
        up = max(r0, k + b)
        if up < r1:
            Bm[up - r0 :, : k + b] -= L[up - r0 :, k : k + b] @ Lik
    return Li


def cho_solve_inv(Li: torch.Tensor, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """Solve (L L^T) x = b given Li = inv(L): two GEMVs/GEMMs.

    ``mesh``: Li holds this rank's rows [r0, r1) (`tri_inv`) and b is whole:
    Li b gives y's local rows, and Li^T y = sum_i Li[i]^T y_i the partial
    sums of those rows, all-reduced over 'schur'."""
    if mesh is not None:
        return mesh.reduce(Li.mT @ (Li @ b), "schur")
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
