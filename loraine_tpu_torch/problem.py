"""Problem representation: dense and rank-1 block groups on one device.

Port of `loraine_tpu/problem.py` (dense and rank-1 storage). The solved
problem, in the reference's convention (`src/model.jl:8-49`)::

    max  b^T y - b_const
    s.t. sum_j y_j A_j^{(i)}  <=  C^{(i)}     (PSD order, i = 1..nlmi)

LMI blocks are bucketed by padded size and stacked, exactly as the JAX
package does, so the padded shapes are identical: ``A [nb, n, m, m]`` (dense)
or factors ``B [nb, n, m]`` with signs ``Bsgn [nb, n]`` (rank-1, A_j =
sgn_j b_j b_j^T). Padding is exact: a block of size m0 padded to m is the
same SDP with a trailing ``0 <= I`` identity tail (A padded with zeros, C
with an identity tail).

Not ported yet: the sparse COO storage (ROADMAP Queue A item 10) and the LP
cone (item 8); building a problem that needs either raises
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .io.sdpa import SDPAData, read_sdpa
from .utils.device import resolve_device

__all__ = [
    "BlockGroup",
    "SDPProblem",
    "problem_from_dense",
    "problem_from_sdpa",
    "pick_storage",
    "RANK1_TOL",
]

# Reference rank-1 conversion guard: `src/model.jl:189-191`.
RANK1_TOL = 5.0e-6


@dataclasses.dataclass
class BlockGroup:
    """A bucket of equally-(padded-)sized LMI blocks, stacked on axis 0.

    Exactly one data representation is present:
      dense:  ``A [nb, n, m, m]``
      rank-1: ``B [nb, n, m]`` + ``Bsgn [nb, n]`` (A_j = sgn_j b_j b_j^T)

    ``orig_indices[b]`` is the position of stacked block b in the user's
    original block ordering (bucketing permutes blocks).
    """

    C: torch.Tensor  # [nb, m, m]
    A: Optional[torch.Tensor]  # [nb, n, m, m] or None
    B: Optional[torch.Tensor]  # [nb, n, m] or None
    Bsgn: Optional[torch.Tensor]  # [nb, n] or None
    m: int
    nb: int
    orig_sizes: Tuple[int, ...]
    orig_indices: Tuple[int, ...]
    # host-side norms for the initial point: per block
    # ||AA_i||_F = sqrt(sum_j ||A_j||_F^2) and ||C_i||_F
    data_norms: Tuple[float, ...] = ()
    C_norms: Tuple[float, ...] = ()

    @property
    def is_rank1(self) -> bool:
        return self.B is not None


@dataclasses.dataclass
class SDPProblem:
    groups: Tuple[BlockGroup, ...]
    b: torch.Tensor  # [n]
    C_lin: Optional[torch.Tensor]  # always None in this port (no LP cone yet)
    d_lin: Optional[torch.Tensor]
    n: int
    nlin: int
    nlmi: int  # number of LMI blocks (sum of group nb)
    b_const: float
    sum_msizes: int  # sum of padded block sizes (mu normalization)

    @property
    def device(self) -> torch.device:
        return self.b.device


# ---------------------------------------------------------------------------
# Host-side block payloads (numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _BlockData:
    """One LMI block on the host: dense C plus either dense A or COO A."""

    C: np.ndarray  # [m0, m0]
    A_dense: Optional[np.ndarray] = None  # [n, m0, m0]
    # COO of all A_j: mat index j (0-based), upper-triangle rows/cols, values
    A_coo: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = None

    @property
    def m0(self) -> int:
        return int(self.C.shape[-1])

    def densify(self, n: int) -> np.ndarray:
        if self.A_dense is not None:
            return self.A_dense
        j, r, c, v = self.A_coo
        A = np.zeros((n, self.m0, self.m0))
        np.add.at(A, (j, r, c), v)
        off = r != c
        np.add.at(A, (j[off], c[off], r[off]), v[off])
        return A


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _rank1_factor_sub(sub: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Factor a (small dense) symmetric matrix as sgn * b b^T via its dominant
    eigenpair. Returns (b, sgn, frobenius residual)."""
    sub = (sub + sub.T) / 2.0
    w, V = np.linalg.eigh(sub)
    k = int(np.argmax(np.abs(w)))
    lam, v = w[k], V[:, k]
    sgn = 1.0 if lam >= 0 else -1.0
    b = math.sqrt(abs(lam)) * v
    err = float(np.linalg.norm(sub - sgn * np.outer(b, b)))
    return b, sgn, err


def _rank1_factor_block(blk: _BlockData, n: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Factor every A_j of one block as sgn_j b_j b_j^T.

    Returns (B [n, m0], sgn [n]) or None if any factorization exceeds
    RANK1_TOL (caller falls back to dense, reference `src/Solvers.jl:435-444`).
    """
    m0 = blk.m0
    B = np.zeros((n, m0))
    sgn = np.zeros(n)

    def factor_one(j: int, sub: np.ndarray, nz: np.ndarray) -> bool:
        if nz.size == 0:
            return True
        b, s, err = _rank1_factor_sub(sub)
        if err > RANK1_TOL:
            warnings.warn(
                f"rank-1 conversion error {err:.2e} > {RANK1_TOL:g} for matrix {j};"
                " falling back to datarank = 0"
            )
            return False
        B[j, nz], sgn[j] = b, s
        return True

    if blk.A_coo is not None:
        jj, rr, cc, vv = blk.A_coo
        order = np.argsort(jj, kind="stable")
        jj, rr, cc, vv = jj[order], rr[order], cc[order], vv[order]
        bounds = np.searchsorted(jj, np.arange(n + 1))
        for j in range(n):
            lo, hi = bounds[j], bounds[j + 1]
            if lo == hi:
                continue
            r, c, v = rr[lo:hi], cc[lo:hi], vv[lo:hi]
            nz = np.unique(np.concatenate([r, c]))
            pos = {int(i): k for k, i in enumerate(nz)}
            sub = np.zeros((nz.size, nz.size))
            for a, bcol, val in zip(r, c, v):
                ia, ib = pos[int(a)], pos[int(bcol)]
                sub[ia, ib] += val
                if ia != ib:
                    sub[ib, ia] += val
            if not factor_one(j, sub, nz):
                return None
    else:
        for j in range(n):
            M = np.asarray(blk.A_dense[j])
            nz = np.flatnonzero(np.abs(M).sum(axis=1))
            if nz.size == 0:
                continue
            if not factor_one(j, M[np.ix_(nz, nz)], nz):
                return None
    if not np.any(B):
        warnings.warn("rank-1 factors all zero; falling back to datarank = 0")
        return None
    return B, sgn


# ---------------------------------------------------------------------------
# Storage choice: the JAX package's Kojima-style cost model, verbatim, so the
# port decides dense/sparse exactly as the reference package does.
# ---------------------------------------------------------------------------

GATHER_PENALTY = 64.0
SPARSE_OVERHEAD = 5.0e6


def _max_entries(blk: _BlockData, n: int) -> int:
    """Max per-matrix entry count of the fully expanded (both-triangle) COO
    (`loraine_tpu/problem.py:_expand_coo` counts)."""
    if blk.A_coo is not None:
        j, r, c, _ = blk.A_coo
    else:
        j, r, c = np.nonzero(blk.A_dense)
        keep = r <= c
        j, r, c = j[keep], r[keep], c[keep]
    jf = np.concatenate([j, j[r != c]])
    counts = np.bincount(jf, minlength=n)
    return int(counts.max()) if counts.size else 0


def schur_cost_dense(n: int, m: int, nb: int = 1) -> float:
    """Modeled cost of one dense-path Schur assembly for a block group."""
    return float(nb) * (n * m**3 + n**2 * m**2)


def schur_cost_sparse(n: int, m: int, s: int, nb: int = 1) -> float:
    """Modeled cost of one sparse-path Schur assembly (excl. fixed
    overhead, which is added once per problem in pick_storage)."""
    return float(nb) * (n * s * m**2 + GATHER_PENALTY * n**2 * s)


def pick_storage(n: int, block_stats: List[Tuple[int, int]]) -> str:
    """'dense' or 'sparse' by total modeled Schur-assembly cost.
    ``block_stats``: per LMI block (m, s) with s the max per-matrix nnz."""
    dense = sum(schur_cost_dense(n, m) for m, _ in block_stats)
    sparse = SPARSE_OVERHEAD + sum(
        schur_cost_sparse(n, m, s) for m, s in block_stats
    )
    return "sparse" if sparse < dense else "dense"


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to loraine_tpu_torch yet; see ROADMAP.md "
        f"Queue A {item}"
    )


def _build_problem(
    blocks: List[_BlockData],
    b: np.ndarray,
    nlin: int,
    b_const: float,
    datarank: int,
    pad_multiple: int,
    dtype: torch.dtype,
    device: torch.device,
    storage: str = "auto",
    max_dense_gb: float = 4.0,
    sparse_max_nnz: Optional[int] = None,
    sparse_min_n: int = 256,
) -> SDPProblem:
    """Port of `loraine_tpu/problem.py:_build_problem` (dense and rank-1
    branches)."""
    if nlin > 0:
        raise _unported("the LP cone (nlin > 0)", "item 8 (multi-block + LP cone)")
    n = int(np.asarray(b).shape[0])
    nlmi = len(blocks)

    use_rank1 = datarank == -1
    factors: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * nlmi
    if use_rank1:
        for i, blk in enumerate(blocks):
            f = _rank1_factor_block(blk, n)
            if f is None:
                use_rank1 = False
                break
            factors[i] = f

    mode = storage
    if use_rank1:
        mode = "rank1"
    elif storage == "auto":
        dense_bytes = sum((n + 1) * blk.m0**2 * 8 for blk in blocks)
        stats = [(blk.m0, _max_entries(blk, n)) for blk in blocks]
        s_max = max((s for _, s in stats), default=0)
        if dense_bytes > max_dense_gb * 1e9:
            mode = "sparse"
        elif sparse_max_nnz is None:
            mode = pick_storage(n, stats)
        elif s_max <= sparse_max_nnz and n >= sparse_min_n:
            mode = "sparse"
        else:
            mode = "dense"
    if mode == "sparse":
        raise _unported("sparse COO storage", "item 10 (sparse COO storage)")
    if mode not in ("dense", "rank1"):
        raise ValueError(f"storage must be auto/dense/sparse, got {storage!r}")
    if mode == "rank1" and not use_rank1:
        raise ValueError("rank-1 storage requires datarank=-1 and factorizable data")

    buckets = {}
    for i, blk in enumerate(blocks):
        m_pad = _round_up(blk.m0, pad_multiple)
        buckets.setdefault(m_pad, []).append(i)

    # small blocks: one batched group at the max padded size (the JAX
    # package's layout rule, kept so the padded shapes are identical)
    if len(buckets) > 1:
        m_max = max(buckets)
        merged_bytes = (n + 1) * nlmi * m_max * m_max * 8
        if m_max <= 128 and merged_bytes <= 32 * 1024**2:
            idxs = [i for k in sorted(buckets) for i in buckets[k]]
            buckets = {m_max: idxs}

    def dev(x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(device=device, dtype=dtype)

    groups = []
    for m_pad in sorted(buckets):
        idxs = buckets[m_pad]
        Cstack, Astack, Bstack, Sgnstack, sizes = [], [], [], [], []
        for i in idxs:
            blk = blocks[i]
            m0 = blk.m0
            sizes.append(m0)
            Cp = np.zeros((m_pad, m_pad))
            Cp[:m0, :m0] = blk.C
            Cp[range(m0, m_pad), range(m0, m_pad)] = 1.0  # identity tail
            Cstack.append(Cp)
            if mode == "rank1":
                B, sgn = factors[i]
                Bp = np.zeros((n, m_pad))
                Bp[:, :m0] = B
                Bstack.append(Bp)
                Sgnstack.append(sgn)
            else:
                Ap = np.zeros((n, m_pad, m_pad))
                Ap[:, :m0, :m0] = blk.densify(n)
                Astack.append(Ap)

        if mode == "rank1":
            data_norms = tuple(
                float(np.sqrt(np.sum(np.sum(B**2, axis=-1) ** 2))) for B in Bstack
            )
        else:
            data_norms = tuple(float(np.sqrt(np.sum(A**2))) for A in Astack)
        groups.append(
            BlockGroup(
                C=dev(np.stack(Cstack)),
                A=dev(np.stack(Astack)) if mode == "dense" else None,
                B=dev(np.stack(Bstack)) if mode == "rank1" else None,
                Bsgn=dev(np.stack(Sgnstack)) if mode == "rank1" else None,
                m=m_pad,
                nb=len(idxs),
                orig_sizes=tuple(sizes),
                orig_indices=tuple(idxs),
                data_norms=data_norms,
                C_norms=tuple(float(np.linalg.norm(Ci)) for Ci in Cstack),
            )
        )

    return SDPProblem(
        groups=tuple(groups),
        b=dev(b),
        C_lin=None,
        d_lin=None,
        n=n,
        nlin=0,
        nlmi=nlmi,
        b_const=float(b_const),
        sum_msizes=sum(g.m * g.nb for g in groups),
    )


def problem_from_dense(
    As: Sequence[np.ndarray],
    Cs: Sequence[np.ndarray],
    b: np.ndarray,
    C_lin: Optional[np.ndarray] = None,
    d_lin: Optional[np.ndarray] = None,
    b_const: float = 0.0,
    datarank: int = 0,
    pad_multiple: int = 8,
    dtype: torch.dtype = torch.float64,
    storage: str = "auto",
    device: Union[str, torch.device] = "cuda",
) -> SDPProblem:
    """Build an SDPProblem from per-block dense numpy data.

    Args:
      As: per LMI block, array [n, m_i, m_i] of data matrices A_j.
      Cs: per LMI block, array [m_i, m_i].
      b: objective vector [n] (maximize b^T y).
      C_lin, d_lin: the LP cone; not ported yet (must be None).
      datarank: -1 attempts the rank-one compression (5e-6 guard with dense
        fallback).
      storage: 'auto' | 'dense' ('sparse' is not ported yet).
      device: where the data lives ('cuda' by default; raises without a card).
    """
    device = resolve_device(device)
    blocks = [
        _BlockData(C=np.asarray(C, dtype=np.float64), A_dense=np.asarray(A, dtype=np.float64))
        for A, C in zip(As, Cs)
    ]
    nlin = 0 if C_lin is None else int(np.asarray(C_lin).shape[1])
    return _build_problem(
        blocks, np.asarray(b, dtype=np.float64), nlin, b_const, datarank,
        pad_multiple, dtype, device, storage=storage,
    )


def problem_from_sdpa(
    source: Union[str, SDPAData],
    datarank: int = 0,
    pad_multiple: int = 8,
    dtype: torch.dtype = torch.float64,
    max_dense_gb: float = 4.0,
    storage: str = "auto",
    sparse_max_nnz: Optional[int] = None,
    sparse_min_n: int = 256,
    device: Union[str, torch.device] = "cuda",
) -> SDPProblem:
    """Convert SDPA data (min c^T x s.t. sum x_j F_j - F_0 >= 0) to the
    internal dual form: y = x, b = -c, A_j = -F_j, C = -F_0. The reported
    objective ``-b^T y`` then equals SDPA's optimal ``c^T x``. Diagonal
    (LP) blocks are not ported yet and raise NotImplementedError."""
    device = resolve_device(device)
    data = read_sdpa(source) if isinstance(source, str) else source
    n = data.nvar

    blocks: List[_BlockData] = []
    nlin = 0
    for bs, (mat, row, col, val) in zip(data.block_sizes, data.blocks):
        if bs < 0:
            nlin += -bs
            continue
        C = np.zeros((bs, bs))
        f0 = mat == 0
        np.add.at(C, (row[f0], col[f0]), -val[f0])
        offd = f0 & (row != col)
        np.add.at(C, (col[offd], row[offd]), -val[offd])
        fj = ~f0
        blocks.append(
            _BlockData(C=C, A_coo=(mat[fj] - 1, row[fj], col[fj], -val[fj]))
        )

    return _build_problem(
        blocks,
        b=-np.asarray(data.c, dtype=np.float64),
        nlin=nlin,
        b_const=0.0,
        datarank=datarank,
        pad_multiple=pad_multiple,
        dtype=dtype,
        device=device,
        storage=storage,
        max_dense_gb=max_dense_gb,
        sparse_max_nnz=sparse_max_nnz,
        sparse_min_n=sparse_min_n,
    )
