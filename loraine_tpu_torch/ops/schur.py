"""Schur-complement assembly and data-operator contractions, batched. Port
of `loraine_tpu/ops/schur.py` (`Aop`, `Aadj`, `schur_group` on dense,
rank-1 and sparse storage; `lp_weight`, `schur_lp`).

    H[j,k] = sum_i < A_j^{(i)}, W_i A_k^{(i)} W_i >
             + (C_lin diag(x_lin / s_lin) C_lin^T)[j,k]

Dense data: two batched GEMMs T = W A W and one [n, n] contraction, chunked
over constraints when the [nb, n, m, m] temporary would be large. Rank-1
data (A_j = sgn_j b_j b_j^T): H = sum_b sgn sgn' o ((B G)(B G)^T)^2
(`makeBBBB_rank1`, `src/makeBBBB.jl:1-20`). Sparse data: gathers and
rank-s outer products, chunked over constraints. All are gathers and GEMMs
left to torch and cuBLAS, as the JAX package leaves them to XLA; none is a
Pallas kernel there.

    Aop(group, X)  = [ sum_b <A_j^{(b)}, X_b> ]_j          ([n])
    Aadj(group, y) = sum_j y_j A_j^{(b)}                    ([nb, m, m])

The sparse `Aadj` is a scatter-add in the JAX package. Here it sums over
the per-cell layout `problem.AdjLayout` (gathers and fixed-shape sums, then
a collision-free placement), so its result is the same bit for bit from run
to run on a card, where a scatter-add would be float atomics.
"""
from __future__ import annotations

import torch

from ..problem import BlockGroup

__all__ = ["Aop", "Aadj", "schur_group", "lp_weight", "schur_lp"]

# above this many elements of the [nb, n, m, m] temporary T = W A W the
# dense assembly runs in constraint chunks (`schur.py:173`)
_DENSE_CHUNK_ELEMS = 1 << 24


def Aop(group: BlockGroup, X: torch.Tensor) -> torch.Tensor:
    """[n] <- sum over the group's blocks of <A_j, X_b>."""
    if group.is_rank1:
        vals = ((group.B @ X) * group.B).sum(-1)  # [nb, n]
        return (group.Bsgn * vals).sum(0)
    if group.is_sparse:
        # <A_j, X> = sum_t v_t X[r_t, c_t] (COO fully expanded)
        bidx = torch.arange(group.nb, device=X.device)[:, None, None]
        return (group.Avals * X[bidx, group.Arows, group.Acols]).sum((0, 2))
    nb, n, m, _ = group.A.shape
    return torch.einsum("bjx,bx->j", group.A.reshape(nb, n, m * m), X.reshape(nb, m * m))


def Aadj(group: BlockGroup, y: torch.Tensor) -> torch.Tensor:
    """[nb, m, m] <- sum_j y_j A_j per block."""
    if group.is_rank1:
        w = group.Bsgn * y[None, :]  # [nb, n]
        return (group.B * w[:, :, None]).mT @ group.B
    if group.is_sparse:
        return _aadj_sparse(group, y)
    nb, n, m, _ = group.A.shape
    return torch.einsum("j,bjx->bx", y, group.A.reshape(nb, n, m * m)).reshape(nb, m, m)


def schur_group(group: BlockGroup, W: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """[n, n] <- this group's contribution to H."""
    if group.is_rank1:
        BG = group.B @ G  # [nb, n, m]
        P = BG @ BG.mT  # [nb, n, n]
        sgn = group.Bsgn
        return ((sgn[:, :, None] * sgn[:, None, :]) * P * P).sum(0)
    if group.is_sparse:
        return _schur_sparse(group, W)
    nb, n, m, _ = group.A.shape
    if nb * n * m * m > _DENSE_CHUNK_ELEMS:
        return _schur_dense_chunked(group, W)
    T = W[:, None] @ group.A @ W[:, None]  # [nb, n, m, m]
    return torch.einsum("bjx,bkx->jk", group.A.reshape(nb, n, m * m), T.reshape(nb, n, m * m))


def _schur_dense_chunked(group: BlockGroup, W: torch.Tensor) -> torch.Tensor:
    """Dense Schur contribution with the constraint axis processed in chunks
    of J (`schur.py:_schur_dense_chunked`): H rows [J, n] per chunk from
    T_chunk = W A_chunk W flattened against the full data stack. Same cost,
    peak temporary O(J m^2) instead of O(n m^2)."""
    nb, n, m, _ = group.A.shape
    J = int(min(n, max(8, (1 << 22) // max(1, nb * m * m))))
    Aflat = group.A.movedim(1, 0).reshape(n, nb * m * m)
    rows = []
    for j0 in range(0, n, J):
        T = W[:, None] @ group.A[:, j0 : j0 + J] @ W[:, None]  # [nb, J, m, m]
        rows.append(T.movedim(1, 0).reshape(T.shape[1], nb * m * m) @ Aflat.T)
    return torch.cat(rows, dim=0)


def _aadj_sparse(group: BlockGroup, y: torch.Tensor) -> torch.Tensor:
    """sum_j y_j A_j over the per-cell layout: level-1 row sums, level-2
    cell sums, placement at unique cells (pads land in a dropped slot)."""
    L, m = group.adj, group.m
    nb = L.cells.shape[0]
    t = (y[L.j] * L.v).sum(-1)  # [nb, R]
    t = torch.cat([t, t.new_zeros((nb, 1))], dim=1)  # slot R: the pad zero
    cell = torch.gather(t, 1, L.rows.reshape(nb, -1)).reshape(L.rows.shape).sum(-1)
    out = t.new_zeros((nb, m * m + 1)).scatter_(1, L.cells, cell)
    return out[:, : m * m].reshape(nb, m, m)


def _schur_sparse(group: BlockGroup, W: torch.Tensor) -> torch.Tensor:
    """Sparse-data Schur contribution (`schur.py:_schur_sparse`):

        T_j = W A_j W = sum_t v_t W[:, r_t] W[c_t, :]     (rank-s outer sum)
        H[j, k] = <A_k, T_j> = sum_u v_u T_j[r_u, c_u]    (gather + reduce)

    in chunks of J constraints, with the JAX package's chunk rule so the
    gathered [nb, J, n, s] tensor stays near 2^25 elements."""
    nb, n, s = group.Avals.shape
    m = group.m
    J = int(min(n, max(8, (1 << 25) // max(1, nb * n * s))))
    flatk = (group.Arows * m + group.Acols).reshape(nb, 1, n * s)
    bidx = torch.arange(nb, device=W.device)[:, None, None]
    rows = []
    for j0 in range(0, n, J):
        r_c, c_c = group.Arows[:, j0 : j0 + J], group.Acols[:, j0 : j0 + J]
        v_c = group.Avals[:, j0 : j0 + J]
        Wa, Wc = W[bidx, r_c], W[bidx, c_c]  # [nb, J, s, m] (W symmetric)
        T2 = ((Wa * v_c[..., None]).mT @ Wc).reshape(nb, -1, m * m)
        G = torch.gather(T2, 2, flatk.expand(nb, T2.shape[1], n * s))
        rows.append(torch.einsum("bjks,bks->jk", G.reshape(nb, -1, n, s), group.Avals))
    return torch.cat(rows, dim=0)


def lp_weight(X_lin: torch.Tensor, S_lin_inv: torch.Tensor) -> torch.Tensor:
    return X_lin * S_lin_inv


def schur_lp(C_lin: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[n, n] <- C_lin diag(w) C_lin^T."""
    return (C_lin * w[None, :]) @ C_lin.T
