"""Mixed-precision blocked Cholesky: f32 panels refined to f64 by Newton
passes. Port of `loraine_tpu/ops/mixed_chol.py` (`_PANEL_ACCEPT`, `_phi`,
`panel_chol_mixed`, `chol_mixed_blocked`); ``chol_backend='mixed'``.

Per panel of ``base`` = 128 columns of a right-looking blocked elimination:

    D    = T[:b, :b]                  (f64, trailing-updated)
    L32  = chol(f32(D)),  Li32 = L32^-1           (f32)
    3 Newton passes:  E = D - L L^T  (f64)
                      F = Li32 f32(E) Li32^T      (f32)
                      L += L phi(F)  (f64; phi = tril + diag/2)
    2 inverse passes: Li <- Li (2I - L Li)        (f64)
    off-diagonal panel  L_rk = R Li_kk^T, trailing update T -= L_rk L_rk^T

A panel falls back to the f64 factorization (`torch.linalg.cholesky_ex`
plus a triangular solve for its inverse, NaN on and below the diagonal where
it fails, as `linalg._chol_nan`) when the f32 seed fails or the last Newton
residual max|F| exceeds `_PANEL_ACCEPT`. The JAX package decides both with
a `lax.cond`; here each is a host decision, one per panel for the whole
batch: up to two host syncs a panel (14 a factorization at n = 800, 52 at
n = 3240). `STATS` counts panels, fallbacks and syncs. NaN semantics match
the f64 factorization, so `chol_reg`'s shift loop works unchanged.

No kernel: the products, the Cholesky factorizations and the triangular
solves are library calls (cuBLAS/cuSOLVER on the card, LAPACK on the CPU),
as the JAX package leaves them to XLA. The f32 seed comes from another
LAPACK than the JAX package's, so the two factors agree to the Newton
passes' accuracy (~1e-13 relative), not bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .linalg import _chol_nan

__all__ = ["panel_chol_mixed", "chol_mixed_blocked", "STATS"]

# accept the mixed panel when the last Newton residual F = Li E Li^T is at
# most this (spectral-relative) size (`mixed_chol.py:50-57`)
_PANEL_ACCEPT = 1e-7

# panels factored, panels that took the f64 fallback, host syncs
STATS = {"panels": 0, "fallbacks": 0, "syncs": 0}


def _phi(F: torch.Tensor) -> torch.Tensor:
    """Lower-triangular half-projection: tril(F, -1) + diag(F)/2."""
    return torch.tril(F, -1) + 0.5 * torch.tril(torch.triu(F))


def _fallback(D: torch.Tensor, eye: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    STATS["fallbacks"] += 1
    L = _chol_nan(D)
    return L, torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def panel_chol_mixed(D: torch.Tensor, passes: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor a (batched) f64 SPD panel: returns (L, Li) in f64, from the f32
    seed and ``passes`` Newton refinements, or from the f64 fallback for the
    whole batch (see the module docstring)."""
    b = D.shape[-1]
    eye = torch.eye(b, dtype=D.dtype, device=D.device)
    STATS["panels"] += 1
    L32, info = torch.linalg.cholesky_ex(D.to(torch.float32))
    STATS["syncs"] += 1
    if bool((info != 0).any() | torch.isnan(L32).any()):
        return _fallback(D, eye)
    Li32 = torch.linalg.solve_triangular(L32, eye.to(torch.float32).expand_as(L32), upper=False)
    L = L32.to(D.dtype)
    Fmax = torch.zeros((), dtype=D.dtype, device=D.device)
    for _ in range(passes):
        E = D - L @ L.mT
        F = (Li32 @ E.to(torch.float32) @ Li32.mT).to(D.dtype)
        Fmax = F.abs().max()
        L = L + L @ _phi(F)
    # refine the inverse to f64: Li <- Li (2I - L Li), twice
    Li = Li32.to(D.dtype)
    for _ in range(2):
        Li = Li @ (2.0 * eye - L @ Li)
    STATS["syncs"] += 1
    if not bool(Fmax <= _PANEL_ACCEPT):  # a NaN residual falls back too
        return _fallback(D, eye)
    return L, torch.tril(Li)


def chol_mixed_blocked(M: torch.Tensor, base: int = 128) -> torch.Tensor:
    """Batched lower Cholesky, blocked right-looking with mixed-precision
    panels: a drop-in for the f64 factorization, with its NaN semantics."""
    n = M.shape[-1]
    if n <= base:
        return panel_chol_mixed(M)[0]
    batch = M.shape[:-2]
    cols = []
    T = M
    k = 0
    while k < n:
        b = min(base, n - k)
        Ld, Ldi = panel_chol_mixed(T[..., :b, :b])
        if k + b < n:
            Lr = T[..., b:, :b] @ Ldi.mT  # R L_kk^-T, one GEMM
            col = torch.cat([Ld, Lr], dim=-2)
            T = T[..., b:, b:] - Lr @ Lr.mT
        else:
            col = Ld
        if k:
            col = torch.cat([M.new_zeros(batch + (k, b)), col], dim=-2)
        cols.append(col)
        k += b
    return torch.cat(cols, dim=-1)
