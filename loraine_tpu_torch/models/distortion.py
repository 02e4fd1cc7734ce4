"""Minimum-distortion Euclidean embedding SDP (reference behavior:
`examples/ex_dist.jl`).

Given a metric D on 4 points, find the smallest c^2 >= 1 such that a PSD
Gram matrix Q (with Q[0,0] = 0) embeds the metric with distortion c:

    D_ij^2 <= Q_ii + Q_jj - 2 Q_ij <= c^2 D_ij^2.

Exercises mixed scalar LP variables + PSD matrix variables + slacks.
Anchors: objective 4/3 and the explicit optimal Q (`examples/ex_dist.jl:
29,35-40`). Port of `loraine_tpu/models/distortion.py`.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..problem import problem_from_dense

__all__ = ["minimum_distortion"]


def minimum_distortion(
    D: Optional[np.ndarray] = None, options: Optional[dict] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[float, np.ndarray]:
    """Returns (c^2, Q). Default D is the reference's star-metric example."""
    from ..ipm.solver import solve

    if D is None:
        D = np.array(
            [
                [0.0, 1.0, 1.0, 1.0],
                [1.0, 0.0, 2.0, 2.0],
                [1.0, 2.0, 0.0, 2.0],
                [1.0, 2.0, 2.0, 0.0],
            ]
        )
    nv = D.shape[0]
    pairs = [(i, j) for i in range(nv) for j in range(i + 1, nv)]
    npair = len(pairs)

    # LP variables x_lin = [c2, s0 (c2 slack), s_lo (npair), s_hi (npair)]
    nlin = 2 + 2 * npair
    # constraints:
    #   0: c2 - s0 = 1
    #   1..npair:        <M_ij, Q> - s_lo = D_ij^2
    #   npair+1..2npair: <M_ij, Q> - c2 D_ij^2 + s_hi = 0
    #   last:            Q[0, 0] = 0
    n = 2 * npair + 2
    A = np.zeros((n, nv, nv))
    b = np.zeros(n)
    C_lin = np.zeros((n, nlin))
    d_lin = np.zeros(nlin)
    d_lin[0] = 1.0  # objective: min c2

    C_lin[0, 0] = 1.0
    C_lin[0, 1] = -1.0
    b[0] = 1.0
    for k, (i, j) in enumerate(pairs):
        M = np.zeros((nv, nv))
        M[i, i] += 1.0
        M[j, j] += 1.0
        M[i, j] -= 1.0
        M[j, i] -= 1.0
        A[1 + k] = M
        C_lin[1 + k, 2 + k] = -1.0
        b[1 + k] = D[i, j] ** 2
        A[1 + npair + k] = M
        C_lin[1 + npair + k, 0] = -D[i, j] ** 2
        C_lin[1 + npair + k, 2 + npair + k] = 1.0
    A[-1, 0, 0] = 1.0
    b[-1] = 0.0

    C = np.zeros((nv, nv))
    opts = {"kit": 0, "eDIMACS": 1e-8, "verb": 0, "initpoint": 1}
    opts.update(options or {})
    prob = problem_from_dense([A], [C], b, C_lin=C_lin, d_lin=d_lin, device=device)
    res = solve(prob, opts, device=device)
    c2 = float(res.X_lin[0])
    Q = res.X[0]
    return c2, Q
