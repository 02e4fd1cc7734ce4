"""Max-cut SDP relaxation (reference behavior: `examples/ex_maxcut.jl`).

    max 1/4 <L, X>   s.t.  diag(X) = 1,  X >= 0 (PSD)

Encoded in the framework's primal form min <C, X> s.t. <A_j, X> = b_j with
C = -L/4, A_j = E_jj, b = 1. The solver's dual objective -b^T y equals
-(max-cut relaxation value); the primal block X is the embedding Gram matrix.
Note the data matrices E_jj are rank one, so this family also exercises the
``datarank = -1`` compression path. Port of `loraine_tpu/models/maxcut.py`.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..problem import SDPProblem, problem_from_dense

__all__ = ["maxcut_problem", "solve_maxcut"]


def maxcut_problem(weights: np.ndarray, datarank: int = 0, pad_multiple: int = 8,
                   device: Union[str, torch.device] = "cuda") -> SDPProblem:
    """Build via the COO (SDPA-data) path: the data matrices are N singleton
    diagonals E_jj, so materializing the dense [N, N, N] stack (the naive
    construction) costs O(N^3) host memory — 512 GB at N=4096. The COO
    build is O(nnz(W) + N)."""
    from ..io.sdpa import SDPAData
    from ..problem import problem_from_sdpa

    W = np.asarray(weights, dtype=np.float64)
    N = W.shape[0]
    # F_0 = -C = L/4 (upper triangle, 0-based), F_j = -A_j = -E_jj, c = -b
    deg = W @ np.ones(N)
    rows0, cols0 = np.nonzero(np.triu(W, 1))
    mat = np.concatenate([
        np.zeros(N + rows0.size, dtype=np.int64),  # F_0 entries
        np.arange(1, N + 1),                       # F_j = -E_jj
    ])
    row = np.concatenate([np.arange(N), rows0, np.arange(N)])
    col = np.concatenate([np.arange(N), cols0, np.arange(N)])
    val = np.concatenate([
        # F_0 diagonal of L/4 with L = diag(W @ 1) - W: the subtraction
        # keeps any nonzero W diagonal from shifting the objective by
        # 0.25*trace(W) (the W[i,i] term appears in deg AND in -W).
        0.25 * (deg - np.diag(W)),
        -0.25 * W[rows0, cols0],
        -np.ones(N),
    ])
    data = SDPAData(
        nvar=N,
        block_sizes=[N],
        c=-np.ones(N),
        blocks=[(mat, row, col, val)],
    )
    return problem_from_sdpa(data, datarank=datarank, pad_multiple=pad_multiple,
                             device=device)


def solve_maxcut(
    weights: np.ndarray, options: Optional[dict] = None, seed: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[List[int], List[int], float]:
    """Solve the relaxation and round with a random hyperplane.

    Returns (S, T, sdp_value) with S/T 0-based partition indices.
    """
    from ..ipm.solver import solve

    opts = {"kit": 0, "eDIMACS": 1e-7, "verb": 0}
    opts.update(options or {})
    prob = maxcut_problem(np.asarray(weights), device=device)
    res = solve(prob, opts, device=device)
    X = res.X[0]
    # res.objective = -b^T y = -<C, X> = <L/4, X>: the relaxation value
    sdp_value = res.objective

    # Random-hyperplane rounding (Goemans-Williamson): X = V^T V via
    # eigendecomposition, cut by sign of a random projection.
    w, U = np.linalg.eigh((X + X.T) / 2)
    w = np.clip(w, 0.0, None)
    V = (U * np.sqrt(w)).T  # columns are embedding vectors
    N = X.shape[0]
    rng = np.random.default_rng(N if seed is None else seed)
    r = rng.standard_normal(V.shape[0])
    r /= np.linalg.norm(r)
    cut = (r @ V) > 0
    S = [i for i in range(N) if cut[i]]
    T = [i for i in range(N) if not cut[i]]
    return S, T, sdp_value
