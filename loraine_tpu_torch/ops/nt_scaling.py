"""Nesterov-Todd scaling point, batched over a block group. Port of
`loraine_tpu/ops/nt_scaling.py` (`nt_scale` with methods 'eigh' and
'svd', `NTScaling`, and the native dd scaling `nt_scale_dd` with its
`NTTails`).

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

`nt_scale_dd` (nt_precision='dd', which 'auto' resolves to on the card at
kit=0 under 'dd2')
runs chol(X), the congruence L_x^T S L_x and its Jacobi eigendecomposition
on dd pairs (`ops/dd_linalg.py`: the kernels D2, D3 and D1 on a CUDA
tensor), so the congruent spectrum (~mu) survives below the f64 formation
noise u64 ||M||; its dd low words come back as `NTTails`.

The eigen-work of either scaling (`_eigh`, the dd sweeps, the 'svd'
method's SVD) runs inside the span ``ltt.eig`` (`utils/timers.py:span`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.timers import span
from .dd import DD
from .dd_linalg import (dd_chol, dd_const, dd_div, dd_eigh_jacobi, dd_matmul, dd_mul, dd_sqrt,
                        dd_sym, dd_transpose)
from .eigh import eigh_jacobi, eigh_mixed
from .linalg import chol_reg, eigh_or_nan, svd_or_nan, sym, tri_solve

__all__ = ["NTScaling", "NTTails", "nt_scale", "nt_scale_dd"]


def _eigh(M: torch.Tensor, backend: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``eigh_backend`` dispatch (`loraine_tpu/ops/nt_scaling.py:38-46`)."""
    if backend == "jacobi":
        return eigh_jacobi(M)
    if backend == "mixed":
        return eigh_mixed(M)
    if backend == "pallas":
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
    eigh_backend: str = "pallas",
    chol_backend: str = "f64",
) -> NTScaling:
    """NT scaling for a stacked group of blocks [nb, m, m] by ``method``
    'eigh' or 'svd' (see the module docstring); ``chol_backend`` goes to
    both `chol_reg` calls (`loraine_tpu/ops/nt_scaling.py:82-84,103`)."""
    nb, m = X.shape[0], X.shape[-1]
    if method == "svd":
        cboth = chol_reg(torch.cat([X, S], dim=0), reg_eps, max_reg, backend=chol_backend)
        Lx, Ls = cboth.L[:nb], cboth.L[nb:]
        # singular values come descending, as from jnp.linalg.svd
        with span("eig"):
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
        cx = chol_reg(X, reg_eps, max_reg, backend=chol_backend)
        Lx = cx.L
        # eig(L_x^T S L_x) = V D^2 V^T with the same V as svd(L_s^T L_x)
        M = Lx.mT @ S @ Lx
        with span("eig"):
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


class NTTails(NamedTuple):
    """dd low words of the NT quantities of `nt_scale_dd`; the hi words are
    the sibling `NTScaling`'s, and the step folds these in as first-order
    terms (sandwiches, the Schur assembly, the corrector's target)."""

    D_lo: torch.Tensor  # [nb, m]
    G_lo: torch.Tensor  # [nb, m, m]
    W_lo: torch.Tensor  # [nb, m, m]
    dd_ok: torch.Tensor  # bool scalar: the dd factorizations succeeded everywhere


def nt_scale_dd(
    X: DD,
    S: DD,
    reg_eps: float = 1e-5,
    max_reg: int = 1000,
    eigh_backend: str = "pallas",
    sweeps: Optional[int] = None,
    mesh=None,
) -> Tuple[NTScaling, NTTails]:
    """NT scaling in double-double from dd-stored iterates
    (`loraine_tpu/ops/nt_scaling.py:nt_scale_dd`; the reference's
    `prepare_W` at T = Float64x4, `src/prepare_W.jl:28-94`).

    The f64 `nt_scale` of the hi words is the baseline. Then dd_chol(X),
    M = L_x^T S L_x in dd, the warm start V0 from the ``eigh_backend``
    eigenbasis of M.hi (B1's seed plus the f64 refinement under
    'pallas'), `dd_eigh_jacobi` from V0, a 2^-100 relative clamp of
    the spectrum, and D, D^{-1/2}, G and W in dd; Gi, Si and DDsi from the
    hi words (their consumers are f64).

    Fallback: where the dd Cholesky meets a nonpositive pivot or the
    congruent spectrum is not positive in any block, every output selects
    the f64 baseline with zero tails and ``dd_ok`` is False (a
    `torch.where` select, no host read). ``mesh``: the group's blocks lie
    on the mesh's 'blocks' axis, and ``dd_ok`` is reduced over it, so one
    failing block sends every block to the fallback, as the JAX package's
    global ``.all()`` does."""
    base = nt_scale(X.hi, S.hi, reg_eps=reg_eps, max_reg=max_reg, method="eigh",
                    eigh_backend=eigh_backend)

    Lx, chol_ok = dd_chol(X)
    M = dd_sym(dd_matmul(dd_transpose(Lx), dd_matmul(S, Lx)))
    # warm start from the f64 eigenbasis of M.hi: the dd sweeps then only
    # clean up the ~u64 off-diagonal mass
    with span("eig"):
        _, V0 = _eigh(sym(M.hi), eigh_backend)
        lam, V = dd_eigh_jacobi(M, sweeps=sweeps, V0=V0)

    lam_max = lam.hi[..., -1:].clamp_min(1e-300)
    s_indef = (lam.hi[..., 0] <= 0.0).any()
    dd_ok = chol_ok.all() & ~s_indef
    if mesh is not None:
        dd_ok = mesh.reduce(dd_ok, "blocks", "min")
    ok = base.ok & ~(lam.hi[..., 0] < -1e-2).any()
    # 2^-100 relative (the f64 path's is 1e-14): keeps sqrt and the
    # divides finite in the branch not taken without touching live spectra
    clamp = 2.0**-100 * lam_max
    needs = lam.hi < clamp
    lam = DD(torch.where(needs, clamp, lam.hi), torch.where(needs, 0.0, lam.lo))

    D = dd_sqrt(lam)
    d_isqrt = dd_div(dd_const(1.0, D.hi), dd_sqrt(D))  # D^{-1/2}
    LxV = dd_matmul(Lx, V)
    G = dd_mul(LxV, DD(d_isqrt.hi[..., None, :], d_isqrt.lo[..., None, :]))
    W = dd_sym(dd_matmul(G, dd_transpose(G)))

    # Gi = D^{1/2} V^T Lx^{-1}, Si = G D^{-1} G^T (exact NT identity),
    # DDsi = diag(G^T S G)^{-1/2} = D^{-1/2}
    Gi = torch.sqrt(D.hi)[..., :, None] * tri_solve(Lx.hi, V.hi, trans=True).mT
    Si = sym((G.hi / D.hi[..., None, :]) @ G.hi.mT)
    DDsi = d_isqrt.hi

    def pick(dd_val, f64_val):
        return torch.where(dd_ok, dd_val, f64_val)

    false = torch.zeros((), dtype=torch.bool, device=dd_ok.device)
    nts = NTScaling(
        D=pick(D.hi, base.D), G=pick(G.hi, base.G), Gi=pick(Gi, base.Gi),
        W=pick(W.hi, base.W), Si=pick(Si, base.Si), DDsi=pick(DDsi, base.DDsi),
        ok=torch.where(dd_ok, ok, base.ok),
        shifted=torch.where(dd_ok, false, torch.as_tensor(base.shifted, device=dd_ok.device)),
        s_indef=torch.where(dd_ok, false, base.s_indef),
    )
    tails = NTTails(D_lo=pick(D.lo, torch.zeros_like(base.D)),
                    G_lo=pick(G.lo, torch.zeros_like(base.G)),
                    W_lo=pick(W.lo, torch.zeros_like(base.W)), dd_ok=dd_ok)
    return nts, tails
