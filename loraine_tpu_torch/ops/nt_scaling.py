"""Nesterov-Todd scaling point, batched over a block group. Port of
`loraine_tpu/ops/nt_scaling.py` (`nt_scale` with methods 'eigh' and
'svd', and `NTScaling`).

Reference math (`src/prepare_W.jl:28-94`): per block,

    L_x = chol(X),  L_s = chol(S),  U Sigma V^T = svd(L_s^T L_x),
    D = Sigma,  G = L_x V D^{-1/2},  Gi = D^{1/2} V^T L_x^{-1},  W = G G^T,
    Si = S^{-1},  DDsi = diag(G^T S G)^{-1/2}.

Method 'eigh' (the default) factors only X: V and D^2 come from
eig(L_x^T S L_x) (the same V as svd(L_s^T L_x)) through the ``eigh_backend``
of `ops/eigh.py`, S's definiteness is read off the congruent eigenvalues
(Sylvester), and S^{-1} = G D^{-1} G^T. Cholesky failures on X get the
bounded 1e-5*I shift loop; a congruent spectrum below -1e-2 (the
reference's maximum total S shift) marks the scaling not ok. Method 'svd'
is the reference's formulation, kept as the parity path: chol of X and S
together, the library SVD, S^{-1} by two triangular solves.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .eigh import eigh_backend_for, eigh_jacobi, eigh_mixed
from .linalg import chol_reg, eigh_or_nan, svd_or_nan, sym, tri_solve

__all__ = ["NTScaling", "nt_scale"]


def _eigh(M: torch.Tensor, backend: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``eigh_backend`` dispatch (`loraine_tpu/ops/nt_scaling.py:38-46`)."""
    resolved = eigh_backend_for(backend, M.shape[-1])
    if resolved == "jacobi":
        return eigh_jacobi(M)
    if resolved == "mixed":
        return eigh_mixed(M)
    if resolved == "pallas":
        return eigh_mixed(M, seed="pallas")
    return eigh_or_nan(M)


class NTScaling(NamedTuple):
    D: torch.Tensor  # [nb, m]
    G: torch.Tensor  # [nb, m, m]
    Gi: torch.Tensor  # [nb, m, m]
    W: torch.Tensor  # [nb, m, m]
    Si: torch.Tensor  # [nb, m, m]
    DDsi: torch.Tensor  # [nb, m]
    ok: torch.Tensor  # bool scalar
    shifted: bool  # Cholesky regularization was applied
    s_indef: torch.Tensor  # bool scalar: congruent spectrum of S dipped <= 0


def nt_scale(
    X: torch.Tensor,
    S: torch.Tensor,
    reg_eps: float = 1e-5,
    max_reg: int = 1000,
    method: str = "eigh",
    eigh_backend: str = "auto",
) -> NTScaling:
    """NT scaling for a stacked group of blocks [nb, m, m] by ``method``
    'eigh' or 'svd' (see the module docstring)."""
    nb, m = X.shape[0], X.shape[-1]
    if method == "svd":
        cboth = chol_reg(torch.cat([X, S], dim=0), reg_eps, max_reg)
        Lx, Ls = cboth.L[:nb], cboth.L[nb:]
        # singular values come descending, as from jnp.linalg.svd
        _, D, Vt = svd_or_nan(Ls.mT @ Lx)
        V = Vt.mT
        ok = torch.as_tensor(cboth.ok, device=X.device)
        shifted = cboth.shifts > 0
        s_indef = torch.zeros((), dtype=torch.bool, device=X.device)
        d_isqrt = 1.0 / torch.sqrt(D)
        G = (Lx @ V) * d_isqrt[..., None, :]
        Gi = torch.sqrt(D)[..., :, None] * tri_solve(Lx, V, trans=True).mT
        W = G @ G.mT
        eye = torch.eye(m, dtype=X.dtype, device=X.device).expand_as(X)
        Si = sym(tri_solve(Ls, tri_solve(Ls, eye), trans=True))
    else:
        cx = chol_reg(X, reg_eps, max_reg)
        Lx = cx.L
        # eig(L_x^T S L_x) = V D^2 V^T with the same V as svd(L_s^T L_x)
        M = Lx.mT @ S @ Lx
        lam, V = _eigh(sym(M), eigh_backend)
        # Sylvester: S is PD iff every congruent eigenvalue is positive.
        # Below -1e-2 the scaling has failed; small negatives are clamped
        # relative to the spectrum top, like the reference's graduated
        # +eps*I shifts.
        lam_max = lam[..., -1:].clamp_min(1e-300)
        s_indef = (lam[..., 0] <= 0.0).any()
        ok = (~(lam[..., 0] < -1e-2).any()) & cx.ok
        shifted = cx.shifts > 0
        lam = torch.maximum(lam, 1e-14 * lam_max)
        D = torch.sqrt(lam)

        d_isqrt = 1.0 / torch.sqrt(D)
        G = (Lx @ V) * d_isqrt[..., None, :]
        # Gi = D^{1/2} V^T Lx^{-1};  (Lx^{-T} V)^T = V^T Lx^{-1}
        Gi = torch.sqrt(D)[..., :, None] * tri_solve(Lx, V, trans=True).mT
        W = G @ G.mT
        # S^{-1} = G D^{-1} G^T (exact NT identity)
        Si = sym((G / D[..., None, :]) @ G.mT)

    # diag(G^T S G) without forming the full product
    dd = (G * (S @ G)).sum(-2)
    DDsi = 1.0 / torch.sqrt(dd)

    return NTScaling(
        D=D, G=G, Gi=Gi, W=W, Si=Si, DDsi=DDsi, ok=ok,
        shifted=shifted, s_indef=s_indef,
    )
