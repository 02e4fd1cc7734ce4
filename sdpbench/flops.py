"""Operations one IPM iteration needs, from the instance's own shapes.

Frozen copy of the counts of `loraine_tpu_torch/utils/flops.py` (the
port of `loraine_tpu/utils/flops.py`; complexities from Loraine.jl's
`docs/src/low-rank_data.md:9` and `src/makeBBBB.jl`), kept here so that a
change to the program cannot move the yardstick. One multiply-add is two
operations; EIG_C m^3 is one symmetric eigendecomposition of order m with
its eigenvectors, EIGVALS_C m^3 the eigenvalues alone (the reduction to
tridiagonal form; the tridiagonal eigenvalues are O(m^2)), whichever
algorithm computes them. Per LMI block of order m, over n constraints:

  Schur assembly  rank-1  2 n m^2 + 2 n^2 m
                  dense   4 n m^3 + 2 n^2 m^2
                  sparse  2 S m^2 + 2 n S     (S = the block's entries
                                               over all n constraints)
  NT scaling      chol(X) m^3/3 + one eigendecomposition EIG_C m^3
  steplengths     two steplengths, each a primal and a dual spectrum:
                  4 EIGVALS_C m^3

and once per iteration the Cholesky of the Schur matrix, n^3/3.

Four counts depart from the program's file, so that each is what these
inputs need and not what one implementation does: a steplength needs
eigenvalues alone (the program's file counts 2 EIG_C (2 m^3), as if with
eigenvectors); the factorization leaves out the explicit inverse of the
Cholesky factor (n^3/3 more there: `tri_inv` is the program's choice); a
sparse block counts its entries (S) in place of n times the most entries
of one constraint; and the LP cone adds 2 sum_l k_l^2, k_l the
constraints that touch LP variable l, in place of 2 p n^2 for a dense
[n, p] C_lin. A block whose data is not declared rank-1 (``datarank``
-1) takes the smaller of the dense and the sparse count.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from instance import Instance

EIG_C = 9.0
EIGVALS_C = 4.0 / 3.0


def _lmi_blocks(inst: Instance):
    for size, blk in zip(inst.block_sizes, inst.blocks):
        if size > 0:
            yield size, blk


def iteration(inst: Instance, datarank: int) -> Dict[str, float]:
    """Operations of one iteration by phase, and their total."""
    n = inst.nvar
    asm = nt = steps = 0.0
    for m, (mat, _, _, _) in _lmi_blocks(inst):
        S = float(np.count_nonzero(mat))
        if datarank == -1:
            asm += 2.0 * n * m * m + 2.0 * n * n * m
        else:
            asm += min(4.0 * n * m**3 + 2.0 * n * n * m * m, 2.0 * S * m * m + 2.0 * n * S)
        nt += m**3 / 3.0 + EIG_C * m**3
        steps += 4.0 * EIGVALS_C * m**3
    for size, (mat, row, _, _) in zip(inst.block_sizes, inst.blocks):
        if size < 0:
            k = np.bincount(row[mat > 0], minlength=-size).astype(np.float64)
            asm += 2.0 * float(np.sum(k * k))
    fact = n**3 / 3.0
    return {"assembly": asm, "factorization": fact, "nt_scaling": nt, "steplengths": steps,
            "total": asm + fact + nt + steps}


def jacobi(inst: Instance) -> Dict[str, float]:
    """The eigen-work of the Jacobi kernels' calls in one iteration (B1: the
    NT scaling's eigendecomposition of each block, with eigenvectors; B2:
    the two steplengths' bounds on the smallest eigenvalue of X and of S,
    counted as four spectra without eigenvectors), and the bytes they must
    move in float32: each input matrix read once, each output written once
    (B1's eigenvectors and eigenvalues, B2's two bounds a matrix)."""
    flops = nbytes = 0.0
    for m, _ in _lmi_blocks(inst):
        flops += EIG_C * m**3 + 4.0 * EIGVALS_C * m**3
        nbytes += 4.0 * ((m * m) + (m * m + m) + 2.0 * 2.0 * (m * m + 2))
    return {"flops": flops, "bytes": nbytes}
