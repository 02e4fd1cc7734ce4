"""Schur-complement assembly and data-operator contractions, batched. Port
of `loraine_tpu/ops/schur.py` (`Aop`, `Aadj`, `schur_group` on dense,
rank-1 and sparse storage; `lp_weight`, `schur_lp`; the f32 assembly
`schur_group_mixed`, `schur_lp_mixed`).

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

On a problem sharded by `parallel.mesh.shard_problem` (``group.shard``
set) each group holds its own blocks and constraint rows, and the
operators call the mesh's collectives where they contract a sharded axis
(`loraine_tpu/parallel/mesh.py`): `Aop` sums its blocks over 'blocks' and
gathers its rows over 'schur'; `Aadj` takes its rows of y and all-reduces
its partial sum over 'schur'; `schur_group` returns this rank's rows of
H, summed over 'blocks', from its own rows against the column operand that
`shard_problem` placed whole once (`Shard.cols`: A for dense data, B and
Bsgn for rank-1, the COO for sparse).
Without a shard every path is the unsharded one, op for op.

The double-double counterparts for precision 'dd'/'dd2' (`Aop_dd`,
`Aadj_dd`, `schur_group_dd` with `_schur_sparse_dd`, `schur_lp_dd`) run
every GEMM as an Ozaki-sliced exact product (`ops/ozaki.py`) and every
accumulation in dd, as the JAX package does. The sparse `Aadj_dd` reduces
each cell's entries in dd over the same two-level layout.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..problem import BlockGroup
from .dd import DD, dd_add, dd_sum, two_prod, two_sum
from .ozaki import acc_matmul, acc_matvec

__all__ = ["bsum", "gather_rows", "gather_blocks", "Aop", "Aadj", "schur_group",
           "schur_group_mixed", "lp_weight", "schur_lp", "schur_lp_mixed", "Aop_dd", "Aadj_dd",
           "schur_group_dd", "schur_lp_dd"]

# above this many elements of the [nb, n, m, m] temporary T = W A W the
# dense assembly runs in constraint chunks (`schur.py:173`)
_DENSE_CHUNK_ELEMS = 1 << 24


def bsum(group: BlockGroup, x: torch.Tensor) -> torch.Tensor:
    """A sum over the group's blocks, completed over the mesh's 'blocks'
    axis when the group's blocks are sharded (identity otherwise)."""
    sh = group.shard
    return sh.mesh.reduce(x, "blocks") if sh is not None and sh.split_blocks else x


def gather_rows(group: BlockGroup, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The whole constraint axis ``dim`` of ``x`` from this rank's rows
    (identity when the rows are not sharded)."""
    sh = group.shard
    if sh is None or not sh.split_rows:
        return x
    r0, r1 = sh.rows
    return sh.mesh.gather(x, "schur", (r1 - r0) * sh.mesh.shape["schur"], r0, dim)


def gather_blocks(group: BlockGroup, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The group's whole block axis ``dim`` of ``x`` from this rank's blocks
    (identity when the blocks are not sharded)."""
    sh = group.shard
    if sh is None or not sh.split_blocks:
        return x
    return sh.mesh.gather(x, "blocks", len(group.orig_indices), sh.blocks[0], dim)


def Aop(group: BlockGroup, X: torch.Tensor) -> torch.Tensor:
    """[n] <- sum over the group's blocks of <A_j, X_b>."""
    return gather_rows(group, bsum(group, _aop_local(group, X)))


def _aop_local(group: BlockGroup, X: torch.Tensor) -> torch.Tensor:
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
    sh = group.shard
    if sh is not None and sh.split_rows:
        out = _aadj_local(group, y[sh.rows[0] : sh.rows[1]])
        return sh.mesh.reduce(out, "schur")
    return _aadj_local(group, y)


def _aadj_local(group: BlockGroup, y: torch.Tensor) -> torch.Tensor:
    if group.is_rank1:
        w = group.Bsgn * y[None, :]  # [nb, n]
        return (group.B * w[:, :, None]).mT @ group.B
    if group.is_sparse:
        return _aadj_sparse(group, y)
    nb, n, m, _ = group.A.shape
    return torch.einsum("j,bjx->bx", y, group.A.reshape(nb, n, m * m)).reshape(nb, m, m)


def _cols(group: BlockGroup, *own: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The column operand of the group's rows of H: the group's own tensors
    ``own``, or, where its rows are sharded, the same data whole over the
    rows (`Shard.cols`)."""
    sh = group.shard
    return sh.cols if sh is not None and sh.split_rows else own


def schur_group(group: BlockGroup, W: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """[n, n] <- this group's contribution to H; on a sharded group this
    rank's rows [r0, r1) of it, its own rows against the whole column
    operand."""
    if group.is_rank1:
        Bk, sgnk = _cols(group, group.B, group.Bsgn)
        BG = group.B @ G  # [nb, n, m]
        P = BG @ (BG if Bk is group.B else Bk @ G).mT  # [nb, n, n]
        sgn = group.Bsgn
        H = ((sgn[:, :, None] * sgnk[:, None, :]) * P * P).sum(0)
    elif group.is_sparse:
        H = _schur_sparse(group, W)
    else:
        nb, n, m, _ = group.A.shape
        (Ak,) = _cols(group, group.A)
        if Ak is not group.A or nb * n * m * m > _DENSE_CHUNK_ELEMS:
            H = _dense_rows(group.A, Ak, W)
        else:
            T = W[:, None] @ group.A @ W[:, None]  # [nb, n, m, m]
            H = torch.einsum("bjx,bkx->jk", group.A.reshape(nb, n, m * m),
                             T.reshape(nb, n, m * m))
    return bsum(group, H)


def _dense_rows(A_rows: torch.Tensor, A_all: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Dense Schur rows <W A_j W, A_k> for the constraints j of ``A_rows``
    against every k of ``A_all`` (`schur.py:_schur_dense_chunked`), in
    chunks of J = min(n, max(8, 2^22 // (nb m^2))) constraints (the JAX
    package's rule): peak temporary O(J m^2) instead of O(n m^2)."""
    nb, n, m, _ = A_all.shape
    J = int(min(n, max(8, (1 << 22) // max(1, nb * m * m))))
    Aflat = A_all.movedim(1, 0).reshape(n, nb * m * m)
    rows = []
    for j0 in range(0, A_rows.shape[1], J):
        T = W[:, None] @ A_rows[:, j0 : j0 + J] @ W[:, None]  # [nb, J, m, m]
        rows.append(T.movedim(1, 0).reshape(T.shape[1], nb * m * m) @ Aflat.T)
    return torch.cat(rows, dim=0)


def schur_group_mixed(group: BlockGroup, W: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """The f32 Schur contribution of assembly_precision 'f32'/'auto'
    (`loraine_tpu/ops/schur.py:248-313`), used while DIMACS >= 1e-3 and then
    handed over to the exact assembly (`ipm/solver.py`). Rank-1 and sparse
    groups stay exact (`schur_group`), as in the JAX package; a dense group
    runs the chunked contraction with f32 operands: per chunk of J
    constraints T = W A_chunk W and the [J, n] rows T_flat A_flat^T in f32,
    cast back to W.dtype. The chunk rule is the JAX package's,
    J = min(n, max(8, 2^22 // (nb m^2))). The result is accurate to ~1e-6
    relative (f32 accumulation)."""
    if group.is_rank1 or group.is_sparse:
        return schur_group(group, W, G)
    (Ak,) = _cols(group, group.A)
    A32 = group.A.to(torch.float32)
    A32k = A32 if Ak is group.A else Ak.to(torch.float32)
    H = _dense_rows(A32, A32k, W.to(torch.float32)).to(W.dtype)
    return bsum(group, H)


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
    gathered [nb, J, n, s] tensor stays near 2^25 elements. The rows j are
    the group's own, the k run over its column operand (`_cols`)."""
    rows_k, cols_k, vals_k = _cols(group, group.Arows, group.Acols, group.Avals)
    nb, n, s = vals_k.shape
    m = group.m
    J = int(min(n, max(8, (1 << 25) // max(1, nb * n * s))))
    flatk = (rows_k * m + cols_k).reshape(nb, 1, n * s)
    bidx = torch.arange(nb, device=W.device)[:, None, None]
    rows = []
    for j0 in range(0, group.Avals.shape[1], J):
        r_c, c_c = group.Arows[:, j0 : j0 + J], group.Acols[:, j0 : j0 + J]
        v_c = group.Avals[:, j0 : j0 + J]
        Wa, Wc = W[bidx, r_c], W[bidx, c_c]  # [nb, J, s, m] (W symmetric)
        T2 = ((Wa * v_c[..., None]).mT @ Wc).reshape(nb, -1, m * m)
        G = torch.gather(T2, 2, flatk.expand(nb, T2.shape[1], n * s))
        rows.append(torch.einsum("bjks,bks->jk", G.reshape(nb, -1, n, s), vals_k))
    return torch.cat(rows, dim=0)


def lp_weight(X_lin: torch.Tensor, S_lin_inv: torch.Tensor) -> torch.Tensor:
    return X_lin * S_lin_inv


def schur_lp(C_lin: torch.Tensor, w: torch.Tensor, rows: slice = slice(None)) -> torch.Tensor:
    """[n, n] <- C_lin diag(w) C_lin^T; its ``rows`` only when given (the
    LP data is replicated on a mesh)."""
    return (C_lin[rows] * w[None, :]) @ C_lin.T


def schur_lp_mixed(C_lin: torch.Tensor, w: torch.Tensor, rows: slice = slice(None)) -> torch.Tensor:
    """The LP block with its GEMM in f32 (`loraine_tpu/ops/schur.py:451-456`):
    the weighting C_lin diag(w) in C_lin.dtype, then cast."""
    Cw = (C_lin[rows] * w[None, :]).to(torch.float32)
    return (Cw @ C_lin.T.to(torch.float32)).to(C_lin.dtype)


# ---- double-double operators (precision 'dd' and 'dd2')


def _dd_renorm(hi: torch.Tensor, lo: torch.Tensor) -> DD:
    s = hi + lo
    t = (s - hi) + 0.0 * lo  # fold-blocker of the JAX package: see ops/dd.py
    return DD(s, lo - t)


def _flat_data(group: BlockGroup) -> torch.Tensor:
    """The dense data stack as [n, nb*m*m] (constraint-major rows)."""
    nb, n, m, _ = group.A.shape
    return group.A.movedim(1, 0).reshape(n, nb * m * m)


def Aop_dd(group: BlockGroup, M: torch.Tensor, Mlo: Optional[torch.Tensor] = None) -> DD:
    """Aop in double-double: [n] <- sum_b <A_j, M_b> with dd accumulation
    (`schur.py:Aop_dd`); ``Mlo`` is an optional low part of M, entering as
    a plain f64 first-order term. Dense: an Ozaki-exact matvec against the
    flattened stack; rank-1 and sparse: TwoProd and dd tree sums."""
    if group.is_rank1:
        p = two_prod(group.B @ M, group.B)  # f64 inner product, then exact
        vals = dd_sum(p, axis=-1)  # [nb, n]
        w = dd_sum(DD(vals.hi * group.Bsgn, vals.lo * group.Bsgn), axis=0)
        if Mlo is not None:
            corr = (group.Bsgn * ((group.B @ Mlo) * group.B).sum(-1)).sum(0)
            s = two_sum(w.hi, corr)
            w = DD(s.hi, s.lo + w.lo)
        return w
    if group.is_sparse:
        bidx = torch.arange(group.nb, device=M.device)[:, None, None]
        p = two_prod(group.Avals, M[bidx, group.Arows, group.Acols])  # [nb, n, s]
        n = p.hi.shape[1]
        w = dd_sum(DD(p.hi.movedim(1, 0).reshape(n, -1), p.lo.movedim(1, 0).reshape(n, -1)))
        if Mlo is not None:
            corr = (group.Avals * Mlo[bidx, group.Arows, group.Acols]).sum((0, 2))
            s = two_sum(w.hi, corr)
            w = DD(s.hi, s.lo + w.lo)
        return w
    Af = _flat_data(group)
    r = acc_matvec(Af, M.reshape(-1))
    if Mlo is not None:
        s = two_sum(r.hi, Af @ Mlo.reshape(-1))
        r = DD(s.hi, s.lo + r.lo)
    return r


def Aadj_dd(group: BlockGroup, y: DD) -> DD:
    """Aadj at double-double accuracy: [nb, m, m] <- sum_j y_j A_j with the
    contraction in dd and y.lo folded in (`schur.py:Aadj_dd`).

      dense:  Ozaki-exact matvec against the flattened stack;
      rank-1: u_j = (sgn_j y_j) b_j by TwoProd (the sign product is exact),
              then sum_j u_j b_j^T as an Ozaki-exact GEMM;
      sparse: TwoProd per entry and a dd sum per target cell over the
              two-level `AdjLayout` (each level a dd tree sum, the pad slots
              exact zeros), then placement at the unique cells.
    """
    if group.is_rank1:
        w = group.Bsgn * y.hi[None, :]  # sgn in {-1, 0, 1}: exact product
        wlo = group.Bsgn * y.lo[None, :]
        u = two_prod(group.B, w[:, :, None])  # [nb, n, m]
        P = acc_matmul(u.hi.mT, group.B)  # [nb, m, m]
        corr = (u.lo + group.B * wlo[:, :, None]).mT @ group.B
        s = two_sum(P.hi, corr)
        return DD(s.hi, s.lo + P.lo)
    if group.is_sparse:
        L, m = group.adj, group.m
        nb = L.cells.shape[0]
        p = two_prod(L.v, y.hi[L.j])
        t = dd_sum(DD(p.hi, p.lo + L.v * y.lo[L.j]), axis=-1)  # [nb, R] row sums
        pad = t.hi.new_zeros((nb, 1))  # slot R: the pad zero
        rows = L.rows.reshape(nb, -1)

        def gather(x):
            return torch.gather(torch.cat([x, pad], dim=1), 1, rows).reshape(L.rows.shape)

        cell = dd_sum(DD(gather(t.hi), gather(t.lo)), axis=-1)  # [nb, ncell]

        def place(v):
            out = v.new_zeros((nb, m * m + 1)).scatter_(1, L.cells, v)
            return out[:, : m * m].reshape(nb, m, m)

        return DD(place(cell.hi), place(cell.lo))
    nb, n, m, _ = group.A.shape
    AfT = _flat_data(group).mT  # [nb*m*m, n]
    r = acc_matvec(AfT, y.hi)
    s = two_sum(r.hi, AfT @ y.lo)
    return DD(s.hi.reshape(nb, m, m), (s.lo + r.lo).reshape(nb, m, m))


def _schur_sparse_dd(group: BlockGroup, W: torch.Tensor) -> DD:
    """Sparse-data Schur contribution in double-double (`schur.py:
    _schur_sparse_dd`): the gather pipeline of `_schur_sparse` with each COO
    slot's outer product v_t (W e_{r_t})(W e_{c_t})^T entering T2 as TwoProd
    pairs summed in dd, and the contraction against Avals as TwoProd plus dd
    sums; the block axis is summed in dd. Chunks of J constraints with the
    JAX package's rule J = min(n, max(4, 2^21 // (nb m^2)))."""
    nb, n, s = group.Avals.shape
    m = group.m
    J = int(min(n, max(4, (1 << 21) // max(1, nb * m * m))))
    flatk = (group.Arows * m + group.Acols).reshape(nb, 1, n * s)
    bidx = torch.arange(nb, device=W.device)[:, None, None]
    his, los = [], []
    for j0 in range(0, n, J):
        r_c, c_c = group.Arows[:, j0 : j0 + J], group.Acols[:, j0 : j0 + J]
        v_c = group.Avals[:, j0 : j0 + J]
        Wa, Wc = W[bidx, r_c], W[bidx, c_c]  # [nb, Jc, s, m]
        Jc = v_c.shape[1]
        acc = DD(W.new_zeros((nb, Jc, m, m)), W.new_zeros((nb, Jc, m, m)))
        for t in range(s):
            av = two_prod(Wa[:, :, t, :], v_c[:, :, t, None])  # [nb, Jc, m]
            wc = Wc[:, :, t, None, :]
            outer = two_prod(av.hi[..., :, None], wc)
            acc = dd_add(acc, DD(outer.hi, outer.lo + av.lo[..., :, None] * wc))
        idx = flatk.expand(nb, Jc, n * s)
        Ghi = torch.gather(acc.hi.reshape(nb, Jc, m * m), 2, idx).reshape(nb, Jc, n, s)
        Glo = torch.gather(acc.lo.reshape(nb, Jc, m * m), 2, idx).reshape(nb, Jc, n, s)
        hrow = DD(W.new_zeros((nb, Jc, n)), W.new_zeros((nb, Jc, n)))
        for t in range(s):
            av = group.Avals[:, None, :, t]
            p = two_prod(Ghi[..., t], av)
            hrow = dd_add(hrow, DD(p.hi, p.lo + Glo[..., t] * av))
        out = dd_sum(hrow, axis=0)  # [Jc, n]
        his.append(out.hi)
        los.append(out.lo)
    return DD(torch.cat(his, dim=0), torch.cat(los, dim=0))


def schur_group_dd(group: BlockGroup, W: torch.Tensor, G: torch.Tensor) -> DD:
    """Schur contribution in double-double (`schur.py:schur_group_dd`; the
    W_lo/G_lo tail terms of the native dd NT scaling are not ported, ROADMAP
    item 12e): every GEMM an Ozaki-sliced exact product, accumulations dd.

      rank-1: BG = B G exact, P = BG BG^T exact plus the BG.lo cross terms,
              then the elementwise square in dd and the signed block sum;
      sparse: `_schur_sparse_dd`;
      dense:  T = W A W in dd, then H = A_flat T_flat^T in dd."""
    if group.is_rank1:
        BG = acc_matmul(group.B, G)  # [nb, n, m]
        GT = BG.hi.mT
        P = acc_matmul(BG.hi, GT)  # [nb, n, n]
        # lo-part cross terms BG.lo BG.hi^T and its transpose (BG.lo BG.lo^T
        # is below dd resolution)
        cross = BG.lo @ GT
        P = _dd_renorm(P.hi, P.lo + cross + cross.mT)
        sq = two_prod(P.hi, P.hi)
        Psq = _dd_renorm(sq.hi, sq.lo + 2.0 * P.hi * P.lo)
        sgn = group.Bsgn[:, :, None] * group.Bsgn[:, None, :]
        return dd_sum(DD(Psq.hi * sgn, Psq.lo * sgn), axis=0)
    if group.is_sparse:
        return _schur_sparse_dd(group, W)
    nb, n, m, _ = group.A.shape
    WA = acc_matmul(W[:, None], group.A)  # [nb, n, m, m]
    T = acc_matmul(WA.hi, W[:, None])
    T = _dd_renorm(T.hi, T.lo + WA.lo @ W[:, None])
    Af = _flat_data(group)
    Thf = T.hi.movedim(1, 0).reshape(n, -1)
    Tlf = T.lo.movedim(1, 0).reshape(n, -1)
    H = acc_matmul(Af, Thf.mT)
    return _dd_renorm(H.hi, H.lo + Af @ Tlf.mT)


def schur_lp_dd(C_lin: torch.Tensor, w: DD) -> DD:
    """schur_lp at dd accuracy (`schur.py:schur_lp_dd`): the C*w scaling by
    TwoProd, the big product Ozaki-exact, the w.lo first-order term a plain
    f64 GEMM."""
    p = two_prod(C_lin, w.hi[None, :])
    H = acc_matmul(p.hi, C_lin.mT)
    s = two_sum(H.hi, (p.lo + C_lin * w.lo[None, :]) @ C_lin.mT)
    return _dd_renorm(s.hi, s.lo + H.lo)
