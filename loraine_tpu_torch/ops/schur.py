"""Schur-complement assembly and data-operator contractions, batched. Port
of `loraine_tpu/ops/schur.py` (`Aop`, `Aadj`, `schur_group` on dense and
rank-1 storage).

    H[j,k] = sum_i < A_j^{(i)}, W_i A_k^{(i)} W_i >

Dense data: two batched GEMMs T = W A W and one [n, n] contraction, chunked
over constraints when the [nb, n, m, m] temporary would be large. Rank-1
data (A_j = sgn_j b_j b_j^T): H = sum_b sgn sgn' o ((B G)(B G)^T)^2
(`makeBBBB_rank1`, `src/makeBBBB.jl:1-20`). Both are GEMMs left to cuBLAS,
as the JAX package leaves them to XLA.

    Aop(group, X)  = [ sum_b <A_j^{(b)}, X_b> ]_j          ([n])
    Aadj(group, y) = sum_j y_j A_j^{(b)}                    ([nb, m, m])
"""
from __future__ import annotations

import torch

from ..problem import BlockGroup

__all__ = ["Aop", "Aadj", "schur_group"]

# above this many elements of the [nb, n, m, m] temporary T = W A W the
# dense assembly runs in constraint chunks (`schur.py:173`)
_DENSE_CHUNK_ELEMS = 1 << 24


def Aop(group: BlockGroup, X: torch.Tensor) -> torch.Tensor:
    """[n] <- sum over the group's blocks of <A_j, X_b>."""
    if group.is_rank1:
        vals = ((group.B @ X) * group.B).sum(-1)  # [nb, n]
        return (group.Bsgn * vals).sum(0)
    nb, n, m, _ = group.A.shape
    return torch.einsum("bjx,bx->j", group.A.reshape(nb, n, m * m), X.reshape(nb, m * m))


def Aadj(group: BlockGroup, y: torch.Tensor) -> torch.Tensor:
    """[nb, m, m] <- sum_j y_j A_j per block."""
    if group.is_rank1:
        w = group.Bsgn * y[None, :]  # [nb, n]
        return (group.B * w[:, :, None]).mT @ group.B
    nb, n, m, _ = group.A.shape
    return torch.einsum("j,bjx->bx", y, group.A.reshape(nb, n, m * m)).reshape(nb, m, m)


def schur_group(group: BlockGroup, W: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """[n, n] <- this group's contribution to H."""
    if group.is_rank1:
        BG = group.B @ G  # [nb, n, m]
        P = BG @ BG.mT  # [nb, n, n]
        sgn = group.Bsgn
        return ((sgn[:, :, None] * sgn[:, None, :]) * P * P).sum(0)
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
