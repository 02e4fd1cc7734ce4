"""SDPA sparse format (.dat-s) reader/writer.

Port of `loraine_tpu/io/sdpa.py`, which is numpy-only: re-homed here so the
port never imports jax. The SDPA problem is::

    min  c^T x   s.t.   sum_j x_j F_j - F_0  >= 0   (PSD, block diagonal)

Negative block sizes denote diagonal (LP) blocks. Entries are given as
``matno blkno i j value`` with ``matno`` 0 for F_0 and 1..m for F_j, upper
triangle only.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = ["SDPAData", "read_sdpa", "write_sdpa"]


@dataclasses.dataclass
class SDPAData:
    """Raw parsed SDPA data, block-diagonal, 0-based indices.

    Attributes:
      nvar: number of variables m (= number of F_j, j >= 1).
      block_sizes: signed block sizes; negative = diagonal block.
      c: objective vector, shape [nvar].
      blocks: per block, a COO triplet ``(mat, row, col, val)`` arrays where
        ``mat`` is 0 for F_0 and j for F_j; row <= col (upper triangle);
        all 0-based. Diagonal blocks only carry row == col entries.
    """

    nvar: int
    block_sizes: List[int]
    c: np.ndarray
    blocks: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]


def _tokenize(text: str) -> List[str]:
    lines = []
    for line in text.splitlines():
        ls = line.strip()
        if not ls or ls[0] in '*"':
            continue
        lines.append(ls)
    text = " ".join(lines)
    for ch in ",{}()":
        text = text.replace(ch, " ")
    return text.split()


def read_sdpa(path: str) -> SDPAData:
    with open(path, "r") as f:
        toks = _tokenize(f.read())

    pos = 0
    nvar = int(float(toks[pos])); pos += 1
    nblocks = int(float(toks[pos])); pos += 1
    block_sizes = [int(float(t)) for t in toks[pos : pos + nblocks]]; pos += nblocks
    c = np.array([float(t) for t in toks[pos : pos + nvar]], dtype=np.float64); pos += nvar

    ent = np.array(toks[pos:], dtype=np.float64)
    if ent.size % 5 != 0:
        raise ValueError(f"SDPA entry section not a multiple of 5 tokens ({ent.size})")
    ent = ent.reshape(-1, 5)
    mats = ent[:, 0].astype(np.int64)
    blks = ent[:, 1].astype(np.int64) - 1
    rows = ent[:, 2].astype(np.int64) - 1
    cols = ent[:, 3].astype(np.int64) - 1
    vals = ent[:, 4]

    # normalize to upper triangle
    lo = rows > cols
    rows2 = np.where(lo, cols, rows)
    cols2 = np.where(lo, rows, cols)

    blocks = []
    for ib in range(nblocks):
        sel = blks == ib
        blocks.append((mats[sel], rows2[sel], cols2[sel], vals[sel]))
    return SDPAData(nvar=nvar, block_sizes=block_sizes, c=c, blocks=blocks)


def write_sdpa(path: str, data: SDPAData) -> None:
    with open(path, "w") as f:
        f.write(f"{data.nvar}\n{len(data.block_sizes)}\n")
        f.write(" ".join(str(s) for s in data.block_sizes) + "\n")
        f.write(" ".join(repr(float(v)) for v in data.c) + "\n")
        for ib, (mat, row, col, val) in enumerate(data.blocks):
            for m, r, cc, v in zip(mat, row, col, val):
                f.write(f"{int(m)} {ib + 1} {int(r) + 1} {int(cc) + 1} {float(v)!r}\n")
