"""The ('blocks', 'schur') mesh: explicit SPMD over torch.distributed. Port
of `loraine_tpu/parallel/mesh.py`.

The JAX package annotates shardings and lets GSPMD insert the collectives.
Here each rank is one process that holds only its slice of the data, and
the ops call a collective where the JAX program contracts a sharded axis:

- axis 'blocks' shards the stacked LMI blocks ``[nb, ...]`` of a group: the
  NT scaling, the Jacobi kernels B1/B2 and the directions run on a rank's
  own blocks; sums over blocks (traces, the data operator, the Schur
  matrix) are all-reduced over 'blocks', steplength minima and failure
  flags min/max-reduced.
- axis 'schur' shards the constraint axis n: the rows of A, AT, B, Bsgn,
  the COO and the Schur matrix H. ``Aop`` gathers its rows, ``Aadj`` sums
  its local rows and all-reduces over 'schur', H's rows are assembled
  where they live and stay there through the distributed blocked Cholesky
  and ``tri_inv`` (`ops/linalg.py`). A row of H needs every column of the
  data, so each rank also holds its blocks' data whole over the rows
  (`Shard.cols`, placed once): the schur axis splits the work on H, not
  the data's memory.

Vectors of length n (y, b, the right-hand sides, the CG vectors), the LP
data and sigma are replicated. An axis that does not divide an array's
extent evenly is replicated for that array (`loraine_tpu/parallel/mesh.py`
:66-75): tru3's and theta_G100's single-block groups replicate their
blocks axis, a prime n its schur axis.

Only ``all_reduce`` and ``broadcast`` are used, the two collectives that
PyTorch's Gloo backend offers for CUDA tensors, so one code path serves
NCCL across cards and Gloo for ranks that share one card. A row gather is
an all-reduce of a zero-filled full array (exact: each entry has one
non-zero term), so gathered values are the same bits on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ipm.state import IPMState
from ..problem import SDPProblem, Shard, adjoint_layout
from . import distributed

__all__ = ["Mesh", "make_mesh", "auto_mesh", "shard_problem", "shard_state"]

AXES = ("blocks", "schur")

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


class Mesh:
    """A ('blocks', 'schur') mesh of ranks: a
    `torch.distributed.device_mesh.DeviceMesh` with one process group per
    axis, and the few collectives the solver needs. An axis of size 1 makes
    every collective over it the identity."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.shape: Dict[str, int] = dict(zip(AXES, (int(s) for s in device_mesh.shape)))
        self.coords: Dict[str, int] = dict(zip(AXES, device_mesh.get_coordinate()))
        self._groups = {a: device_mesh.get_group(a) for a in AXES}

    @property
    def size(self) -> int:
        return self.shape["blocks"] * self.shape["schur"]

    def split(self, extent: int, axis: str) -> Tuple[int, int, bool]:
        """(lo, hi, split): this rank's range of an axis of ``extent`` entries
        sharded over ``axis``; the whole range, unsplit, where the axis has
        one rank or does not divide ``extent``."""
        k = self.shape[axis]
        if k == 1 or extent % k:
            return 0, extent, False
        step = extent // k
        lo = self.coords[axis] * step
        return lo, lo + step, True

    def reduce(self, x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """All-reduce ``x`` over ``axis`` ('sum', 'min' or 'max'); a new
        tensor. Bool tensors reduce as integers ('max' = any, 'min' = all)."""
        if self.shape[axis] == 1:
            return x
        is_bool = x.dtype == torch.bool
        y = (x.to(torch.int64) if is_bool else x).reshape(-1).clone()
        dist.all_reduce(y, op=_OPS[op], group=self._groups[axis])
        y = y.reshape(x.shape)
        return y.bool() if is_bool else y

    def gather(self, x: torch.Tensor, axis: str, extent: int, lo: int, dim: int = 0) -> torch.Tensor:
        """The whole array from each rank's slice ``[lo, lo + x.shape[dim])``
        of axis ``dim`` (``extent`` entries in all), sharded over ``axis``:
        an all-reduce of a zero-filled full array."""
        if self.shape[axis] == 1:
            return x
        shape = list(x.shape)
        shape[dim] = extent
        full = x.new_zeros(shape)
        full.narrow(dim, lo, x.shape[dim]).copy_(x)
        dist.all_reduce(full, group=self._groups[axis])
        return full

    def agree(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as global rank 0 holds it, on every rank (one broadcast).
        The host loop reads its decisions from such values only, so every
        rank takes the same branch."""
        if self.size == 1:
            return x
        y = x.contiguous().clone()
        dist.broadcast(y, src=0)
        return y


def make_mesh(shape: Sequence[int]) -> Mesh:
    """A ('blocks', 'schur') mesh of the given shape over all ranks of the
    process group (`distributed.initialize` first), on this rank's device
    type."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call distributed.initialize() first")
    nb, ns = (int(s) for s in shape)
    if nb * ns != dist.get_world_size():
        raise ValueError(f"mesh shape {tuple(shape)} needs {nb * ns} ranks, "
                         f"have {dist.get_world_size()}")
    return Mesh(init_device_mesh(distributed.device().type, (nb, ns), mesh_dim_names=AXES))


def auto_mesh(problem: SDPProblem, world_size: Optional[int] = None) -> Mesh:
    """The JAX package's heuristic (`loraine_tpu/parallel/mesh.py:43-54`):
    the blocks axis gets the largest divisor of the rank count that also
    divides the largest group's block count; the rest shard the schur
    axis."""
    nranks = world_size or distributed.world_size()
    max_nb = max((g.nb for g in problem.groups), default=1)
    blocks = 1
    for cand in range(min(nranks, max_nb), 0, -1):
        if nranks % cand == 0 and max_nb % cand == 0:
            blocks = cand
            break
    return make_mesh((blocks, nranks // blocks))


def _local(x: Optional[torch.Tensor], *slices) -> Optional[torch.Tensor]:
    return None if x is None else x[slices].clone()


def shard_problem(problem: SDPProblem, mesh: Mesh) -> SDPProblem:
    """This rank's slice of ``problem`` (every rank passes the same whole
    problem): blocks [b0, b1) of each group whose block count the blocks
    axis divides, rows [r0, r1) of the constraint axis when the schur axis
    divides n; b and the LP data replicated. The host-side metadata
    (``orig_sizes``, ``orig_indices``, ``data_norms``, ``C_norms``) stays
    whole: the initial point reads its blocks' norms from it
    (`loraine_tpu/parallel/mesh.py:109-114`). Where the rows are split,
    each group's shard also keeps the data of its blocks whole over the
    rows (`Shard.cols`): the Schur assembly's column operand, so no
    iteration gathers constant data."""
    if problem.shard is not None:
        raise ValueError("problem is already sharded")
    r0, r1, split_rows = mesh.split(problem.n, "schur")
    groups = []
    for g in problem.groups:
        b0, b1, split_blocks = mesh.split(g.nb, "blocks")
        bs, rs = slice(b0, b1), slice(r0, r1)
        adj = None
        whole = ()
        if split_rows:  # H's rows need every column: the whole rows, once
            names = (("B", "Bsgn") if g.is_rank1 else ("Arows", "Acols", "Avals")
                     if g.is_sparse else ("A",))
            whole = tuple(_local(getattr(g, k), bs) for k in names)
        if g.is_sparse:
            rows, cols, vals = (_local(t, bs, rs) for t in (g.Arows, g.Acols, g.Avals))
            adj = adjoint_layout(rows.cpu().numpy(), cols.cpu().numpy(),
                                 vals.cpu().numpy(), g.m, vals.dtype, vals.device)
        groups.append(dataclasses.replace(
            g,
            C=_local(g.C, bs),
            A=_local(g.A, bs, rs),
            B=_local(g.B, bs, rs),
            Bsgn=_local(g.Bsgn, bs, rs),
            Arows=_local(g.Arows, bs, rs),
            Acols=_local(g.Acols, bs, rs),
            Avals=_local(g.Avals, bs, rs),
            adj=adj,
            nb=b1 - b0,
            shard=Shard(mesh, (r0, r1), split_rows, (b0, b1), split_blocks, whole),
        ))
    return dataclasses.replace(problem, groups=tuple(groups),
                               shard=Shard(mesh, (r0, r1), split_rows))


def shard_state(state: IPMState, problem: SDPProblem, mesh: Mesh) -> IPMState:
    """This rank's slice of ``state`` (an iterate of the whole ``problem``):
    each group's X and S, and their dd2 tails (`mesh.py:138-143`), cut to
    the blocks `shard_problem` gives this rank; y, the LP variables and
    sigma replicated."""
    def cut(ts):
        if ts is None:
            return None
        out = []
        for g, t in zip(problem.groups, ts):
            b0, b1, _ = mesh.split(g.nb, "blocks")
            out.append(t[b0:b1].clone())
        return tuple(out)

    return dataclasses.replace(state, X=cut(state.X), S=cut(state.S),
                               X_lo=cut(state.X_lo), S_lo=cut(state.S_lo))
