"""Problem representation: dense, rank-1 and sparse block groups plus the
LP cone, on one device. Port of `loraine_tpu/problem.py`.

The solved problem, in the reference's convention (`src/model.jl:8-49`)::

    max  b^T y - b_const
    s.t. sum_j y_j A_j^{(i)}  <=  C^{(i)}     (PSD order, i = 1..nlmi)
         C_lin^T y            <=  d_lin       (elementwise)

LMI blocks are bucketed by padded size and stacked, exactly as the JAX
package does, so the padded shapes are identical: ``A [nb, n, m, m]``
(dense), factors ``B [nb, n, m]`` with signs ``Bsgn [nb, n]`` (rank-1,
A_j = sgn_j b_j b_j^T), or the fully expanded COO ``Arows/Acols/Avals
[nb, n, s]`` (sparse). Padding is exact: a block of size m0 padded to m is
the same SDP with a trailing ``0 <= I`` identity tail (A padded with zeros,
C with an identity tail). The LP cone ``C_lin [n, nlin]`` is dense on the
device. On the host it stays in the form it arrives in: the dense entry
points (`problem_from_dense`, `problem_from_dict`) hand over a dense array,
while `problem_from_sdpa` keeps its diagonal blocks as (row, column, value)
entries, which the device scatters into a zeroed ``C_lin``. Either way
`SDPProblem` carries the host values the initial point needs (``b_host``,
``C_lin_row_norms``, ``d_lin_norm``), so `ipm/initial.py` reads nothing
back from the device.

Sparse groups also carry `AdjLayout`, built once at load time: the COO
entries regrouped by target cell so that the adjoint sum_j y_j A_j is a
gather and fixed-shape sums (`ops/schur.py` `Aadj`). The JAX package's
scatter-add would be float atomics on a card, whose result changes from run
to run in the last bit.

Each entry (`problem_from_sdpa`, `problem_from_dense`, `problem_from_dict`)
runs inside the span ``ltt.build`` (`utils/timers.py:span`), with
`_build_problem`'s phases as its children (``ltt.build.lp`` only where
there is an LP cone).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .io.sdpa import SDPAData, read_sdpa
from .utils.device import resolve_device
from .utils.timers import span

__all__ = [
    "AdjLayout",
    "BlockGroup",
    "Shard",
    "SDPProblem",
    "problem_from_dense",
    "problem_from_dict",
    "problem_from_sdpa",
    "pick_storage",
    "adjoint_layout",
    "RANK1_TOL",
]

# Reference rank-1 conversion guard: `src/model.jl:189-191`.
RANK1_TOL = 5.0e-6


class AdjLayout(NamedTuple):
    """The sparse COO of one group regrouped by target cell, for a sparse
    adjoint with a fixed summation order. Per block, the entries of cell c
    (flat index r*m + col) are split into rows of K consecutive entries;
    level 1 sums each row, level 2 sums each cell's rows.

      j     [nb, R, K]        int64 constraint index of each entry (pad 0)
      v     [nb, R, K]        value (pad 0.0)
      rows  [nb, ncell, R2]   int64 level-1 rows of each cell (pad R, a zero)
      cells [nb, ncell]       int64 flat target r*m + col (pad m*m, dropped)
    """

    j: torch.Tensor
    v: torch.Tensor
    rows: torch.Tensor
    cells: torch.Tensor


class Shard(NamedTuple):
    """Where this rank's slice of a problem sharded by
    `parallel.mesh.shard_problem` lies. On `SDPProblem` only the rows are
    set; on a `BlockGroup` the blocks too."""

    mesh: Any  # parallel.mesh.Mesh
    rows: Tuple[int, int]  # [r0, r1) of the constraint axis held here
    split_rows: bool  # rows sharded over the mesh's 'schur' axis
    blocks: Tuple[int, int] = (0, 0)  # [b0, b1) of the group's stacked blocks
    split_blocks: bool = False  # blocks sharded over the 'blocks' axis
    # the column operand of this rank's rows of H, whole over the
    # constraint axis (its own blocks), placed once where the rows are
    # split: (A,) dense, (B, Bsgn) rank-1, (Arows, Acols, Avals) sparse
    cols: Tuple[torch.Tensor, ...] = ()


@dataclasses.dataclass
class BlockGroup:
    """A bucket of equally-(padded-)sized LMI blocks, stacked on axis 0.

    Exactly one data representation is present:
      dense:  ``A [nb, n, m, m]``
      rank-1: ``B [nb, n, m]`` + ``Bsgn [nb, n]`` (A_j = sgn_j b_j b_j^T)
      sparse: ``Arows/Acols [nb, n, s]`` int64 + ``Avals [nb, n, s]``, the
              fully expanded COO (both triangles listed) padded to the
              group's max entry count s with (0, 0, 0.0) entries; ``adj``
              its per-cell layout

    ``orig_indices[b]`` is the position of stacked block b in the user's
    original block ordering (bucketing permutes blocks).

    Sharded (``shard`` set, `parallel/mesh.py`): the tensors hold this
    rank's blocks ``shard.blocks`` and constraint rows ``shard.rows``
    (``adj`` indexes the local rows), ``nb`` counts the local blocks, and
    the host-side tuples (sizes, indices, norms) stay whole.
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
    Arows: Optional[torch.Tensor] = None  # [nb, n, s] int64
    Acols: Optional[torch.Tensor] = None  # [nb, n, s] int64
    Avals: Optional[torch.Tensor] = None  # [nb, n, s]
    adj: Optional[AdjLayout] = None
    shard: Optional[Shard] = None

    @property
    def is_rank1(self) -> bool:
        return self.B is not None

    @property
    def is_sparse(self) -> bool:
        return self.Avals is not None


@dataclasses.dataclass
class SDPProblem:
    groups: Tuple[BlockGroup, ...]
    b: torch.Tensor  # [n]
    C_lin: Optional[torch.Tensor]  # [n, nlin] or None
    d_lin: Optional[torch.Tensor]  # [nlin] or None
    n: int
    nlin: int
    nlmi: int  # number of LMI blocks (sum of group nb)
    b_const: float
    sum_msizes: int  # sum of padded block sizes (mu normalization)
    # host-side values for the initial point, from the values the device
    # holds: b in the problem's dtype, the LP cone's row 2-norms [n]
    # (float64, None without an LP cone) and ||d_lin||
    b_host: np.ndarray
    C_lin_row_norms: Optional[np.ndarray]
    d_lin_norm: float
    # this rank's slice of a sharded problem (`parallel/mesh.py`): n, nlmi
    # and sum_msizes stay global, b and the LP data are replicated
    shard: Optional[Shard] = None

    @property
    def device(self) -> torch.device:
        return self.b.device

    @property
    def mesh(self):
        """The mesh a sharded problem lies on, or None."""
        return None if self.shard is None else self.shard.mesh

    @property
    def rows_split(self) -> bool:
        """Whether the constraint axis (H's rows) is sharded."""
        return self.shard is not None and self.shard.split_rows


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


class LPEntries(NamedTuple):
    """The LP cone as entries on the host: C_lin[rows[k], cols[k]] is the
    sum of the vals of its (row, column), summed in entry order from 0.0,
    as `np.add.at` into a zeroed array sums them."""

    rows: np.ndarray  # int64 constraint index
    cols: np.ndarray  # int64 LP column
    vals: np.ndarray  # float64


def held(x, dtype: torch.dtype) -> np.ndarray:
    """``x`` on the host as a device of ``dtype`` holds it (no copy where
    ``x`` is a float64 array and ``dtype`` float64)."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(dtype).numpy()


def lp_cone(C_lin: Union[np.ndarray, LPEntries], d_lin: np.ndarray, n: int,
            dtype: torch.dtype, device: torch.device):
    """The LP cone on ``device`` and its host norms: (C_lin [n, nlin],
    d_lin [nlin], the row 2-norms of C_lin [n] float64, ||d_lin||).

    A dense ``C_lin`` is copied as it is. `LPEntries` are summed per
    (row, column) on the host and scattered into a zeroed [n, nlin] on the
    device (one write an index: no atomics), the same tensor bit for bit."""
    d = held(d_lin, dtype)
    d_norm = float(np.linalg.norm(d))
    d_dev = torch.as_tensor(d).to(device=device)
    if not isinstance(C_lin, LPEntries):
        C = held(C_lin, dtype)
        return (torch.as_tensor(C).to(device=device), d_dev,
                np.linalg.norm(C, axis=1).astype(np.float64), d_norm)
    nlin = d.shape[0]
    cells, inv = np.unique(C_lin.rows * nlin + C_lin.cols, return_inverse=True)
    vals = held(np.bincount(inv.reshape(-1), weights=C_lin.vals, minlength=cells.size), dtype)
    v64 = vals.astype(np.float64)
    row_norms = np.sqrt(np.bincount(cells // nlin, weights=v64 * v64, minlength=n))
    C = torch.zeros((n, nlin), dtype=dtype, device=device)
    C.view(-1).index_copy_(0, torch.as_tensor(cells).to(device=device),
                           torch.as_tensor(vals).to(device=device))
    return C, d_dev, row_norms, d_norm


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
# Sparse COO: expansion, storage choice, per-cell adjoint layout
# ---------------------------------------------------------------------------


def _expand_coo(blk: _BlockData, n: int) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
    """Full (both-triangle) COO of every A_j of one block, and the per-matrix
    entry counts (`loraine_tpu/problem.py:_expand_coo`)."""
    if blk.A_coo is not None:
        j, r, c, v = blk.A_coo
    else:
        j, r, c = np.nonzero(blk.A_dense)
        keep = r <= c  # upper triangle; expansion below restores symmetry
        j, r, c = j[keep], r[keep], c[keep]
        v = blk.A_dense[j, r, c]
    off = r != c
    jf = np.concatenate([j, j[off]])
    rf = np.concatenate([r, c[off]])
    cf = np.concatenate([c, r[off]])
    vf = np.concatenate([v, v[off]])
    counts = np.bincount(jf, minlength=n)
    return (jf, rf, cf, vf), counts


# The JAX package's Kojima-style cost model, verbatim, so the port decides
# dense/sparse exactly as the reference package does.
GATHER_PENALTY = 64.0
SPARSE_OVERHEAD = 5.0e6


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


def adjoint_layout(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, m: int,
    dtype: torch.dtype, device: torch.device,
) -> AdjLayout:
    """The `AdjLayout` of a padded COO ``rows/cols/vals [nb, n, s]`` (numpy),
    on ``device`` (no JAX counterpart; the arrays of `_adjoint_arrays`)."""
    return _upload_adj(_adjoint_arrays(rows, cols, vals, m), dtype, device)


def _upload_adj(host: AdjLayout, dtype: torch.dtype, device: torch.device) -> AdjLayout:
    """A host `AdjLayout` of numpy arrays on ``device``."""
    return AdjLayout(
        j=torch.as_tensor(host.j).to(device=device),
        v=torch.as_tensor(host.v).to(device=device, dtype=dtype),
        rows=torch.as_tensor(host.rows).to(device=device),
        cells=torch.as_tensor(host.cells).to(device=device),
    )


def _adjoint_arrays(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, m: int) -> AdjLayout:
    """`AdjLayout`'s arrays on the host (numpy) for a padded COO ``rows/
    cols/vals [nb, n, s]``.

    Rows are K = ceil(sqrt(kmax)) entries wide, kmax being the most entries
    any cell has, so both levels stay near the entry count even when one
    cell is shared by thousands of constraints (thetaG11: kmax 1601). Pad
    slots (value 0.0) are dropped. Within a cell the entries keep their COO
    order (constraint-major), as in the JAX package's scatter."""
    nb, n, s = rows.shape
    per_block = []
    kmax = 1
    for b in range(nb):
        f = (rows[b].astype(np.int64) * m + cols[b].astype(np.int64)).reshape(-1)
        v = vals[b].reshape(-1)
        jj = np.repeat(np.arange(n, dtype=np.int64), s)
        keep = v != 0.0
        f, jj, v = f[keep], jj[keep], v[keep]
        order = np.argsort(f, kind="stable")
        f, jj, v = f[order], jj[order], v[order]
        cells, counts = np.unique(f, return_counts=True)
        per_block.append((cells, counts, jj, v))
        if counts.size:
            kmax = max(kmax, int(counts.max()))
    K = int(math.ceil(math.sqrt(kmax)))
    R2 = -(-kmax // K)
    nrows = [-(-counts // K) for _, counts, _, _ in per_block]
    R = max(max((int(r.sum()) for r in nrows), default=0), 1)
    ncell = max(max((c.size for c, _, _, _ in per_block), default=0), 1)
    J = np.zeros((nb, R, K), dtype=np.int64)
    V = np.zeros((nb, R, K))
    Rows = np.full((nb, ncell, R2), R, dtype=np.int64)
    Cells = np.full((nb, ncell), m * m, dtype=np.int64)
    for b, ((cells, counts, jj, v), nr) in enumerate(zip(per_block, nrows)):
        if not cells.size:
            continue
        first = np.cumsum(counts) - counts  # first entry of each cell
        rank = np.arange(jj.size) - np.repeat(first, counts)
        row0 = np.cumsum(nr) - nr  # first level-1 row of each cell
        row = np.repeat(row0, counts) + rank // K
        J[b, row, rank % K] = jj
        V[b, row, rank % K] = v
        cell_of_row = np.repeat(np.arange(cells.size), nr)
        Rows[b, cell_of_row, np.arange(nr.sum()) - np.repeat(row0, nr)] = np.arange(nr.sum())
        Cells[b, : cells.size] = cells
    return AdjLayout(j=J, v=V, rows=Rows, cells=Cells)


def _build_problem(
    blocks: List[_BlockData],
    b: np.ndarray,
    C_lin: Optional[Union[np.ndarray, LPEntries]],
    d_lin: Optional[np.ndarray],
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
    """Port of `loraine_tpu/problem.py:_build_problem`, in the spans
    (`utils/timers.py:span`) ``ltt.build.factors`` (the rank-1 factors),
    ``ltt.build.layout`` (the storage choice and each group's host arrays:
    padded stacks, the sparse COO slots and `AdjLayout`),
    ``ltt.build.upload`` (the host arrays copied to ``device``) and, with an
    LP cone, ``ltt.build.lp`` (`lp_cone`). ``C_lin`` is a dense [n, nlin]
    array or `LPEntries`."""
    n = int(np.asarray(b).shape[0])
    nlmi = len(blocks)

    use_rank1 = datarank == -1
    factors: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * nlmi
    with span("build.factors"):
        if use_rank1:
            for i, blk in enumerate(blocks):
                f = _rank1_factor_block(blk, n)
                if f is None:
                    use_rank1 = False
                    break
                factors[i] = f

    with span("build.layout"):
        mode = _storage_mode(blocks, n, use_rank1, storage, max_dense_gb, sparse_max_nnz,
                             sparse_min_n)
        layouts = [_group_layout(blocks, idxs, m_pad, n, mode, factors)
                   for m_pad, idxs in _buckets(blocks, nlmi, n, pad_multiple)]

    with span("build.upload"):
        def dev(x: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(device=device, dtype=dtype)

        groups = []
        for host, meta in layouts:
            sparse = {}
            if mode == "sparse":
                sparse = dict(
                    Arows=torch.as_tensor(host["Arows"]).to(device=device),
                    Acols=torch.as_tensor(host["Acols"]).to(device=device),
                    Avals=dev(host["Avals"]),
                    adj=_upload_adj(host["adj"], dtype, device),
                )
            groups.append(BlockGroup(
                C=dev(host["C"]),
                A=dev(host["A"]) if mode == "dense" else None,
                B=dev(host["B"]) if mode == "rank1" else None,
                Bsgn=dev(host["Bsgn"]) if mode == "rank1" else None,
                **meta, **sparse,
            ))

        b_host = held(b, dtype)
        b_dev = torch.as_tensor(b_host).to(device=device)

    lp = (None, None, None, 0.0)
    if C_lin is not None and np.size(d_lin):
        with span("build.lp"):
            lp = lp_cone(C_lin, d_lin, n, dtype, device)
    C_dev, d_dev, row_norms, d_norm = lp
    return SDPProblem(
        groups=tuple(groups),
        b=b_dev,
        C_lin=C_dev,
        d_lin=d_dev,
        n=n,
        nlin=0 if d_dev is None else int(d_dev.shape[0]),
        nlmi=nlmi,
        b_const=float(b_const),
        sum_msizes=sum(g.m * g.nb for g in groups),
        b_host=b_host,
        C_lin_row_norms=row_norms,
        d_lin_norm=d_norm,
    )


def _storage_mode(blocks: List[_BlockData], n: int, use_rank1: bool, storage: str,
                  max_dense_gb: float, sparse_max_nnz: Optional[int], sparse_min_n: int) -> str:
    """The storage of the whole problem: rank-1 when it applies, else the
    modeled-cost choice, an explicit nnz threshold, or sparse when dense
    data would not fit."""
    mode = storage
    if use_rank1:
        mode = "rank1"
    elif storage == "auto":
        dense_bytes = sum((n + 1) * blk.m0**2 * 8 for blk in blocks)
        stats = []
        for blk in blocks:
            _, counts = _expand_coo(blk, n)
            stats.append((blk.m0, int(counts.max()) if counts.size else 0))
        s_max = max((s for _, s in stats), default=0)
        if dense_bytes > max_dense_gb * 1e9:
            mode = "sparse"
            if s_max > (64 if sparse_max_nnz is None else sparse_max_nnz):
                warnings.warn(
                    f"data too large for dense storage and not very sparse "
                    f"(max {s_max} entries/matrix); using the sparse path anyway"
                )
        elif sparse_max_nnz is None:
            mode = pick_storage(n, stats)
        elif s_max <= sparse_max_nnz and n >= sparse_min_n:
            mode = "sparse"
        else:
            mode = "dense"
    if mode not in ("dense", "sparse", "rank1"):
        raise ValueError(f"storage must be auto/dense/sparse, got {storage!r}")
    if mode == "rank1" and not use_rank1:
        raise ValueError("rank-1 storage requires datarank=-1 and factorizable data")
    return mode


def _buckets(blocks: List[_BlockData], nlmi: int, n: int, pad_multiple: int):
    """(padded size, block indices) of each group, by ascending size."""
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
    return [(m_pad, buckets[m_pad]) for m_pad in sorted(buckets)]


def _group_layout(blocks: List[_BlockData], idxs: List[int], m_pad: int, n: int, mode: str,
                  factors) -> Tuple[dict, dict]:
    """One group's host arrays (numpy, by `BlockGroup` field) and its
    host-side fields."""
    Cstack, Astack, Bstack, Sgnstack, sizes, coo_blocks = [], [], [], [], [], []
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
        elif mode == "sparse":
            coo_blocks.append(_expand_coo(blk, n))
        else:
            Ap = np.zeros((n, m_pad, m_pad))
            Ap[:, :m0, :m0] = blk.densify(n)
            Astack.append(Ap)

    host = {"C": np.stack(Cstack)}
    if mode == "sparse":
        # padded slot layout of the JAX package: per matrix, its entries
        # in COO order in slots 0..count-1, pads (0, 0, 0.0)
        s_grp = max(max((int(c.max()) if c.size else 0) for _, c in coo_blocks), 1)
        Arows = np.zeros((len(idxs), n, s_grp), dtype=np.int64)
        Acols = np.zeros((len(idxs), n, s_grp), dtype=np.int64)
        Avals = np.zeros((len(idxs), n, s_grp))
        for bpos, ((jf, rf, cf, vf), counts) in enumerate(coo_blocks):
            order = np.argsort(jf, kind="stable")
            jf, rf, cf, vf = jf[order], rf[order], cf[order], vf[order]
            slot = np.concatenate([np.arange(c) for c in counts]) if jf.size else jf
            Arows[bpos, jf, slot] = rf
            Acols[bpos, jf, slot] = cf
            Avals[bpos, jf, slot] = vf
        host.update(Arows=Arows, Acols=Acols, Avals=Avals,
                    adj=_adjoint_arrays(Arows, Acols, Avals, m_pad))
        data_norms = tuple(float(np.sqrt(np.sum(Avals[i] ** 2))) for i in range(len(idxs)))
    elif mode == "rank1":
        host.update(B=np.stack(Bstack), Bsgn=np.stack(Sgnstack))
        data_norms = tuple(
            float(np.sqrt(np.sum(np.sum(B**2, axis=-1) ** 2))) for B in Bstack
        )
    else:
        host["A"] = np.stack(Astack)
        data_norms = tuple(float(np.sqrt(np.sum(A**2))) for A in Astack)
    meta = dict(m=m_pad, nb=len(idxs), orig_sizes=tuple(sizes), orig_indices=tuple(idxs),
                data_norms=data_norms, C_norms=tuple(float(np.linalg.norm(Ci)) for Ci in Cstack))
    return host, meta


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
      C_lin: optional [n, nlin]; d_lin: optional [nlin] (the LP cone
        C_lin^T y <= d_lin).
      datarank: -1 attempts the rank-one compression (5e-6 guard with dense
        fallback).
      storage: 'auto' | 'dense' | 'sparse' data representation (auto picks
        sparse for small-support data with large n).
      device: where the data lives ('cuda' by default; raises without a card).
    """
    with span("build"):
        device = resolve_device(device)
        blocks = [
            _BlockData(C=np.asarray(C, dtype=np.float64), A_dense=np.asarray(A, dtype=np.float64))
            for A, C in zip(As, Cs)
        ]
        return _build_problem(
            blocks, np.asarray(b, dtype=np.float64), C_lin, d_lin, b_const, datarank,
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
    internal dual form: y = x, b = -c, A_j = -F_j, C = -F_0; diagonal blocks
    map to the LP cone with C_lin[j, l] = -diag(F_j)_l, d_lin = -diag(F_0).
    The reported objective ``-b^T y`` then equals SDPA's optimal ``c^T x``."""
    with span("build"):
        device = resolve_device(device)
        data = read_sdpa(source) if isinstance(source, str) else source
        n = data.nvar

        blocks: List[_BlockData] = []
        lp: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []  # LPEntries' parts
        lp_d: List[np.ndarray] = []
        nlin = 0
        for bs, (mat, row, col, val) in zip(data.block_sizes, data.blocks):
            if bs < 0:
                dl = np.zeros(-bs)
                f0 = mat == 0  # diagonal blocks: row == col
                np.add.at(dl, row[f0], -val[f0])
                lp.append((mat[~f0] - 1, row[~f0] + nlin, -val[~f0]))
                lp_d.append(dl)
                nlin -= bs
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
            C_lin=LPEntries(*(np.concatenate(x) for x in zip(*lp))) if lp else None,
            d_lin=np.concatenate(lp_d) if lp_d else None,
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


def problem_from_dict(
    d: dict,
    datarank: int = 0,
    pad_multiple: int = 8,
    dtype: torch.dtype = torch.float64,
    device: Union[str, torch.device] = "cuda",
) -> SDPProblem:
    """Raw-dict entry point (`loraine_tpu/problem.py:problem_from_dict`; the
    working replacement for the reference's broken `loraine(d, options)`
    path, `src/Loraine.jl:30-93` / `src/model.jl:90-118`). Keys (reference
    convention, negated internally like `prepare_model_data`):

      nvar, nlmi, msizes, A (list over blocks of [n, m, m] with the
      *constraint* sign, i.e. internal A_j = -A[i][j]), C (list of [m, m],
      internal C_i = -C[i])  -- or pre-negated 'As'/'Cs' (with 'b') in the
      internal convention, taken as given; c (objective, b = -c), b_const;
      optional nlin, d, C_lin.

    Storage follows `_build_problem`'s 'auto' rule, as in the JAX package.
    ``device``: where the problem lives ('cuda' by default; raises without
    a card)."""
    with span("build"):
        device = resolve_device(device)
        n = int(d.get("nvar", len(np.atleast_1d(d.get("c")))))
        if "As" in d:
            As = [np.asarray(a) for a in d["As"]]
            Cs = [np.asarray(c) for c in d["Cs"]]
            b = np.asarray(d["b"], dtype=np.float64)
        else:
            As = [-np.asarray(a) for a in d["A"]]
            Cs = [-np.asarray(c) for c in d["C"]]
            b = -np.asarray(d["c"], dtype=np.float64)
        b_const = -float(d.get("b_const", 0.0))
        nlin = int(d.get("nlin", 0))
        C_lin = d_lin = None
        if nlin > 0:
            C_lin = -np.asarray(d["C_lin"]) if "C_lin" in d else None
            d_lin = -np.asarray(d["d"]).reshape(-1)
        blocks = [_BlockData(C=C, A_dense=A) for A, C in zip(As, Cs)]
        if b.shape[0] != n:
            raise ValueError(f"nvar={n} inconsistent with objective length {b.shape[0]}")
        return _build_problem(blocks, b, C_lin, d_lin, b_const, datarank, pad_multiple, dtype, device)
