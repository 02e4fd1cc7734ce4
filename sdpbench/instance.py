"""SDPA instances as the benchmark holds them: parsed by the benchmark
itself, relabeled from the seed, and handed unchanged to both the program
and the reference.

An instance is ``min c^T x  s.t.  sum_j x_j F_j - F_0 >= 0`` (PSD, block
diagonal; a negative block size is a diagonal block, the LP cone). Each
block holds the COO entries ``(mat, row, col, val)`` of F_0 (mat 0) and of
F_1..F_n (mat j), 0-based, upper triangle (row <= col).

A relabeling permutes the constraint order (c and F_1..F_n together), the
rows and columns of each LMI block symmetrically, and the LP variables. It
gives the same problem with the same optimum in another order, so every
seed sends the same sizes and the same work.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

Block = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]  # mat, row, col, val


@dataclasses.dataclass
class Instance:
    nvar: int
    block_sizes: List[int]
    c: np.ndarray
    blocks: List[Block]


def read_sdpa(path: str) -> Instance:
    """Parse an SDPA sparse file (``.dat-s``): comment lines start with
    ``*`` or ``"``; ``, { } ( )`` separate like blanks."""
    with open(path) as f:
        text = " ".join(ln.strip() for ln in f if ln.strip() and ln.strip()[0] not in '*"')
    for ch in ",{}()":
        text = text.replace(ch, " ")
    tok = text.split()
    nvar, nblocks = int(float(tok[0])), int(float(tok[1]))
    sizes = [int(float(t)) for t in tok[2:2 + nblocks]]
    pos = 2 + nblocks
    c = np.array(tok[pos:pos + nvar], dtype=np.float64)
    ent = np.array(tok[pos + nvar:], dtype=np.float64)
    if ent.size % 5:
        raise ValueError(f"{path}: entry section is not a multiple of 5 numbers ({ent.size})")
    ent = ent.reshape(-1, 5)
    mat, blk = ent[:, 0].astype(np.int64), ent[:, 1].astype(np.int64) - 1
    r, k = ent[:, 2].astype(np.int64) - 1, ent[:, 3].astype(np.int64) - 1
    row, col = np.minimum(r, k), np.maximum(r, k)
    blocks = [(mat[blk == b], row[blk == b], col[blk == b], ent[blk == b, 4])
              for b in range(nblocks)]
    return Instance(nvar, sizes, c, blocks)


def relabel(inst: Instance, rng: np.random.Generator) -> Instance:
    """``inst`` under a relabeling drawn from ``rng``: the constraints, the
    rows and columns of each LMI block and the LP variables, each permuted."""
    n = inst.nvar
    pc = rng.permutation(n)
    c = np.empty_like(inst.c)
    c[pc] = inst.c
    mat_map = np.concatenate([[0], pc + 1])
    blocks = []
    for size, (mat, row, col, val) in zip(inst.block_sizes, inst.blocks):
        p = rng.permutation(abs(size))
        r, k = p[row], p[col]
        blocks.append((mat_map[mat], np.minimum(r, k), np.maximum(r, k), val.copy()))
    return Instance(n, list(inst.block_sizes), c, blocks)


def request_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of request ``index`` of a run with ``seed`` (any
    non-negative integer, also past 32 bits)."""
    if seed < 0 or index < 0:
        raise ValueError("seed and index must be non-negative")
    return np.random.default_rng([seed, index])


def to_program(inst: Instance, sdpa_data_cls, copy: bool = True):
    """The program's own container of parsed SDPA data, filled with copies
    of this instance's arrays (the program may not write into ours), or
    with the arrays themselves where ``inst`` is handed over and never read
    again (``copy`` False)."""
    own = (lambda a: a.copy()) if copy else (lambda a: a)
    return sdpa_data_cls(
        nvar=inst.nvar,
        block_sizes=list(inst.block_sizes),
        c=own(inst.c),
        blocks=[tuple(own(a) for a in blk) for blk in inst.blocks],
    )
