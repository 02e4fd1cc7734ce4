"""Double-double dense linear algebra: scalar ops, GEMM, Cholesky and the
Jacobi eigensolver. Port of `loraine_tpu/ops/dd_linalg.py` (`dd_mul`,
`dd_sqr`, `dd_const`, `dd_div`, `dd_sqrt`, `dd_abs`, `dd_transpose`,
`dd_sym`, `dd_matmul`, `dd_chol`, `dd_eigh_jacobi`).

dd scalars are (hi, lo) f64 pairs (`ops/dd.py`); everything is branch-free
and batched. `dd_matmul` keeps the heavy work GEMM-shaped: hi x hi by the
Ozaki slicing (`ops/ozaki.py`), the cross terms as plain f64 GEMMs (their
own rounding is ~u64^2 of the total). `dd_chol` is the left-looking column
recurrence (m rounds of O(nb m^2) elementwise dd work); `dd_eigh_jacobi` is
the round-robin parallel cyclic Jacobi in dd, in the JAX package's
GEMM-anchored form: every round applies the full rotation matrix J as
``A <- J^T A J``, ``V <- V J`` through `dd_matmul`, so on the card its cost
is f64 GEMMs. The native dd NT scaling (ROADMAP item 12e) is their user;
the IPM step of this package uses the scalar ops only.

The fold-blockers (``0.0 * x`` in `_dealias`, `dd_const`, `dd_sqrt`) work
around the XLA:CPU simplifier in the JAX package; eager torch has none, so
they are harmless here and keep the results bitwise the JAX package's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .dd import DD, dd_add, dd_mul_f64, dd_neg, dd_sum, two_prod, two_sum
from .eigh import _default_sweeps, round_robin_pairs
from .ozaki import acc_matmul

__all__ = [
    "dd_mul",
    "dd_sqr",
    "dd_const",
    "dd_div",
    "dd_sqrt",
    "dd_abs",
    "dd_transpose",
    "dd_sym",
    "dd_matmul",
    "dd_chol",
    "dd_eigh_jacobi",
]


def _renorm(hi: torch.Tensor, lo: torch.Tensor) -> DD:
    s = hi + lo
    t = (s - hi) + 0.0 * lo
    return DD(s, lo - t)


def dd_mul(x: DD, y: DD) -> DD:
    """Full dd * dd (error ~2^-104 relative)."""
    p = two_prod(x.hi, y.hi)
    t = x.hi * y.lo + x.lo * y.hi
    return _renorm(p.hi, p.lo + t)


def _dealias(x: DD) -> DD:
    """A value-identical copy (`dd_linalg.py:75-84`)."""
    return DD(x.hi + 0.0 * x.lo, x.lo + 0.0 * x.hi)


def dd_sqr(x: DD) -> DD:
    """dd square (`dd_mul(x, _dealias(x))`, as in the JAX package)."""
    return dd_mul(x, _dealias(x))


def dd_const(c: float, like: torch.Tensor) -> DD:
    """The dd constant c shaped like ``like``."""
    z = 0.0 * like
    return DD(z + c, z)


def _where(cond, a, b):
    """torch.where with Python-number branches taking the tensor's dtype."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.where(cond, a, b)


def dd_div(x: DD, y: DD) -> DD:
    """dd / dd via three corrected f64 quotients. ``y.hi`` must be nonzero
    (callers sanitize)."""
    yh = _where(y.hi != 0.0, y.hi, 1.0)
    q1 = x.hi / yh
    r = dd_add(x, dd_neg(dd_mul_f64(y, q1)))
    q2 = r.hi / yh
    r2 = dd_add(r, dd_neg(dd_mul_f64(y, q2)))
    q3 = r2.hi / yh
    q = two_sum(q1, q2)
    return _renorm(q.hi, q.lo + q3)


def dd_sqrt(x: DD) -> DD:
    """sqrt of a nonnegative dd (one dd-corrected Newton step); x.hi <= 0
    maps to exactly 0."""
    pos = x.hi > 0.0
    xh = _where(pos, x.hi, 1.0)
    s = torch.sqrt(xh)
    s2 = two_prod(s, s + 0.0 * s)
    r = dd_add(DD(xh, _where(pos, x.lo, 0.0)), DD(-s2.hi, -s2.lo))
    d = r.hi / (2.0 * s)
    out = two_sum(s, d)
    return DD(_where(pos, out.hi, 0.0), _where(pos, out.lo, 0.0))


def dd_abs(x: DD) -> DD:
    neg = x.hi < 0.0
    return DD(torch.where(neg, -x.hi, x.hi), torch.where(neg, -x.lo, x.lo))


def dd_transpose(x: DD) -> DD:
    return DD(x.hi.mT, x.lo.mT)


def dd_sym(x: DD) -> DD:
    s = dd_add(x, dd_transpose(x))
    return DD(0.5 * s.hi, 0.5 * s.lo)  # exact halving


def dd_matmul(A: DD, B: DD, bits: int = 106) -> DD:
    """(A.hi + A.lo) @ (B.hi + B.lo) in dd: the Ozaki-sliced exact GEMM
    stack on hi x hi, plain f64 GEMMs on the cross terms."""
    r = acc_matmul(A.hi, B.hi, bits=bits)
    cross = A.hi @ B.lo + A.lo @ B.hi
    s = two_sum(r.hi, cross)
    return _renorm(s.hi, s.lo + r.lo)


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------


def dd_chol(A: DD) -> Tuple[DD, torch.Tensor]:
    """Batched dd Cholesky of SPD [nb, m, m] dd matrices: (L, ok) with
    A = L L^T to ~2^-104 relative, ``ok`` [nb] False where a pivot was
    nonpositive at dd resolution (L is garbage there).

    Left-looking: at step j, t[i] = sum_k L[i,k] L[j,k] is a dd dot over the
    computed columns (the others are exactly zero)."""
    nb, m, _ = A.hi.shape
    Lh = torch.zeros_like(A.hi)
    Ll = torch.zeros_like(A.hi)
    ok = torch.ones((nb,), dtype=torch.bool, device=A.hi.device)
    rows = torch.arange(m, device=A.hi.device)
    for j in range(m):
        rj = DD(Lh[:, j : j + 1, :], Ll[:, j : j + 1, :])  # [nb, 1, m]
        t = dd_sum(dd_mul(DD(Lh, Ll), rj), axis=-1)  # [nb, m]
        c = dd_add(DD(A.hi[..., j], A.lo[..., j]), dd_neg(t))
        dh, dl = c.hi[:, j : j + 1], c.lo[:, j : j + 1]  # pivot [nb, 1]
        pos = dh > 0.0
        ok = ok & pos[:, 0]
        piv = dd_sqrt(DD(_where(pos, dh, 1.0), _where(pos, dl, 0.0)))
        col = dd_div(c, DD(piv.hi.expand_as(c.hi), piv.lo.expand_as(c.lo)))
        below = (rows > j)[None, :]
        at_j = (rows == j)[None, :]
        Lh[..., j] = _where(below, col.hi, 0.0) + _where(at_j, piv.hi.expand_as(c.hi), 0.0)
        Ll[..., j] = _where(below, col.lo, 0.0) + _where(at_j, piv.lo.expand_as(c.lo), 0.0)
    return DD(Lh, Ll), ok


# ---------------------------------------------------------------------------
# Jacobi eigensolver
# ---------------------------------------------------------------------------


def _rotation(app: DD, aqq: DD, apq: DD) -> Tuple[DD, DD]:
    """dd Givens rotation (c, s) zeroing the (p, q) entries, batched over
    [nb, m]. Pairs with |apq| below 2^-100 sqrt(|app aqq|) (the
    Demmel-Veselic relative criterion) get the identity rotation."""
    scale = torch.sqrt(torch.abs(app.hi * aqq.hi)) + 1e-300
    active = torch.abs(apq.hi) > 2.0**-100 * scale
    apq_s = DD(_where(active, apq.hi, 1.0), _where(active, apq.lo, 0.0))

    num = dd_add(aqq, dd_neg(app))
    den = dd_mul_f64(apq_s, torch.full_like(app.hi, 2.0))
    tau = dd_div(num, den)
    # past |tau| ~ 1e150 use the asymptotic t = 1/(2 tau)
    big = torch.abs(tau.hi) > 1e150
    tau_c = DD(_where(big, 1.0, tau.hi), _where(big, 0.0, tau.lo))
    sgn = torch.where(tau.hi >= 0.0, 1.0, -1.0).to(tau.hi.dtype)
    tau2 = dd_sqr(tau_c)
    one = dd_const(1.0, tau.hi)
    root = dd_sqrt(dd_add(one, tau2))
    den_t = dd_add(dd_abs(tau_c), root)
    t_small = dd_div(one, den_t)
    t_small = DD(sgn * t_small.hi, sgn * t_small.lo)
    t_big = dd_div(one, dd_mul_f64(tau, torch.full_like(tau.hi, 2.0)))
    t = DD(torch.where(big, t_big.hi, t_small.hi), torch.where(big, t_big.lo, t_small.lo))
    t = DD(_where(active, t.hi, 0.0), _where(active, t.lo, 0.0))

    c = dd_div(one, dd_sqrt(dd_add(one, dd_sqr(t))))
    s = dd_mul(t, c)
    return c, s


def _perm_table(pairs: np.ndarray, m: int):
    """perm [nrounds, m] partner index per round, and the 0/1 masks eye_tab
    (= I) and hot_tab (hot_tab[r][perm[j], j] = 1) [nrounds, m, m] that
    scaffold the rotation matrices (`dd_linalg.py:_perm_table`)."""
    nrounds = pairs.shape[0]
    perm = np.empty((nrounds, m), dtype=np.int64)
    for r in range(nrounds):
        p, q = pairs[r, 0], pairs[r, 1]
        perm[r, p] = q
        perm[r, q] = p
    eye = np.broadcast_to(np.eye(m), (nrounds, m, m)).copy()
    hot = np.zeros((nrounds, m, m))
    for r in range(nrounds):
        hot[r, perm[r], np.arange(m)] = 1.0
    return perm, eye, hot


def _dd_take(x: DD, idx: torch.Tensor, axis: int) -> DD:
    return DD(torch.index_select(x.hi, axis, idx), torch.index_select(x.lo, axis, idx))


def _diag(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1)


def _dd_jacobi_impl(M: DD, V0: DD, perm_tab: torch.Tensor, eye_tab: torch.Tensor,
                    hot_tab: torch.Tensor, sweeps: int):
    """The GEMM-anchored sweeps (`dd_linalg.py:_dd_jacobi_impl`): per round
    the rotation matrix J[k, j] = c_j E[k, j] + s_j P[k, j] (exact: the
    masks are 0/1), then A <- J^T A J and V <- V J by `dd_matmul`."""
    nb, m, _ = M.hi.shape
    idx = torch.arange(m, device=M.hi.device)
    Ah, Al, Vh, Vl = M.hi, M.lo, V0.hi, V0.lo
    for _ in range(sweeps):
        for r in range(perm_tab.shape[0]):
            perm = perm_tab[r]
            is_p = idx < perm
            diag = DD(_diag(Ah), _diag(Al))  # [nb, m]
            ajj = _dd_take(diag, perm, 1)
            # the off-diagonal entry A[i, perm[i]] per index i
            gi = perm[None, :, None].expand(nb, m, 1)
            off = DD(torch.gather(Ah, 2, gi)[..., 0], torch.gather(Al, 2, gi)[..., 0])
            c_all, s_all = _rotation(diag, ajj, off)
            # the partner's values, so both indices of a pair use the same c
            # and exactly negated s (the two-sided update stays symmetric)
            c_part = _dd_take(c_all, perm, 1)
            s_part = _dd_take(s_all, perm, 1)
            c = DD(torch.where(is_p, c_all.hi, c_part.hi), torch.where(is_p, c_all.lo, c_part.lo))
            s = DD(torch.where(is_p, -s_all.hi, s_part.hi), torch.where(is_p, -s_all.lo, s_part.lo))
            E, P = eye_tab[r], hot_tab[r]
            J = DD(c.hi[:, None, :] * E + s.hi[:, None, :] * P,
                   c.lo[:, None, :] * E + s.lo[:, None, :] * P)
            A = dd_matmul(dd_transpose(J), dd_matmul(DD(Ah, Al), J))
            V = dd_matmul(DD(Vh, Vl), J)
            Ah, Al, Vh, Vl = A.hi, A.lo, V.hi, V.lo
        # exact resymmetrization once per sweep
        A = dd_sym(DD(Ah, Al))
        Ah, Al = A.hi, A.lo

    lam = DD(_diag(Ah), _diag(Al))
    order = torch.argsort(lam.hi, dim=-1, stable=True)
    lam = DD(torch.gather(lam.hi, -1, order), torch.gather(lam.lo, -1, order))
    vo = order[:, None, :].expand(nb, m, m)
    return lam, DD(torch.gather(Vh, -1, vo), torch.gather(Vl, -1, vo))


def dd_eigh_jacobi(
    M: DD,
    sweeps: Optional[int] = None,
    V0: Optional[torch.Tensor] = None,
) -> Tuple[DD, DD]:
    """Eigendecomposition of a batch of symmetric dd matrices [nb, m, m]:
    M = V diag(lam) V^T, eigenvalues ascending, all in dd.

    ``V0``: optional f64 eigenbasis warm start. It is first made orthogonal
    to ~u64^2 by one dd Newton-Schulz step, then B = V0^T M V0 in dd and the
    sweeps clean up the remaining off-diagonal mass. Defaults: 6 sweeps
    warm, the f64 solver's count + 2 cold."""
    nb, m, _ = M.hi.shape
    dt, dev = M.hi.dtype, M.hi.device
    if sweeps is None:
        sweeps = 6 if V0 is not None else _default_sweeps(m) + 2

    if V0 is not None:
        V0h = V0.to(dt)
        Vdd = DD(V0h, torch.zeros_like(V0h))
        VtV = dd_matmul(dd_transpose(Vdd), Vdd)
        # C = 1.5 I - 0.5 V'V in dd (the diagonal cancellation must be exact)
        eye15 = 1.5 * torch.eye(m, dtype=dt, device=dev).expand_as(VtV.hi)
        C = dd_add(DD(eye15, 0.0 * eye15), DD(-0.5 * VtV.hi, -0.5 * VtV.lo))
        Vdd = dd_matmul(Vdd, C)
        B = dd_sym(dd_matmul(dd_transpose(Vdd), dd_matmul(M, Vdd)))
        Vstart = Vdd
    else:
        eye = torch.eye(m, dtype=dt, device=dev).expand_as(M.hi)
        B = M
        Vstart = DD(eye, torch.zeros_like(eye))

    mm = m + (m % 2)
    if mm != m:
        # odd m: pad with a decoupled diagonal entry above the spectrum
        big = torch.abs(B.hi).sum(-1).max() + 1.0
        Bh = torch.zeros((nb, mm, mm), dtype=dt, device=dev)
        Bl = torch.zeros_like(Bh)
        Bh[:, :m, :m] = B.hi
        Bh[:, m, m] = big
        Bl[:, :m, :m] = B.lo
        Vh = torch.zeros_like(Bh)
        Vl = torch.zeros_like(Bh)
        Vh[:, :m, :m] = Vstart.hi
        Vh[:, m, m] = 1.0
        Vl[:, :m, :m] = Vstart.lo
        B, Vstart = DD(Bh, Bl), DD(Vh, Vl)
    perm, eye_t, hot_t = _perm_table(round_robin_pairs(mm), mm)
    lam, V = _dd_jacobi_impl(
        B, Vstart, torch.as_tensor(perm, device=dev), torch.as_tensor(eye_t, dtype=dt, device=dev),
        torch.as_tensor(hot_t, dtype=dt, device=dev), sweeps,
    )
    if mm != m:
        return DD(lam.hi[:, :m], lam.lo[:, :m]), DD(V.hi[:, :m, :m], V.lo[:, :m, :m])
    return lam, V
