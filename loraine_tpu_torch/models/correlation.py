"""Correlation-bound SDP (reference behavior: `examples/ex_corr.jl`).

Given rho_AB in [-0.2, -0.1] and rho_BC in [0.4, 0.5] with unit diagonal,
bound rho_AC over all PSD correlation matrices. Exercises the mixed
PSD + LP-cone (slack) path and re-solving with both objective senses. Port
of `loraine_tpu/models/correlation.py`.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..problem import problem_from_dense

__all__ = ["correlation_bounds"]


def _msym(i: int, j: int, nv: int = 3) -> np.ndarray:
    M = np.zeros((nv, nv))
    M[i, j] += 0.5
    M[j, i] += 0.5
    return M


def correlation_bounds(options: Optional[dict] = None,
                       device: Union[str, torch.device] = "cuda") -> Tuple[float, float]:
    """Returns (lower, upper) bounds on rho_AC. Reference anchors:
    lower ~ -0.9779977649, upper ~ 0.8719210472."""
    from ..ipm.solver import solve

    opts = {"kit": 0, "eDIMACS": 1e-8, "verb": 0, "initpoint": 1}
    opts.update(options or {})

    nv = 3
    # constraints: 3 unit-diagonal equalities + 4 slack-completed bounds
    A = np.zeros((7, nv, nv))
    for i in range(3):
        A[i, i, i] = 1.0
    A[3] = _msym(0, 1)   # X_AB + s1 = -0.1
    A[4] = -_msym(0, 1)  # -X_AB + s2 = 0.2
    A[5] = -_msym(1, 2)  # -X_BC + s3 = -0.4
    A[6] = _msym(1, 2)   # X_BC + s4 = 0.5
    b = np.array([1.0, 1.0, 1.0, -0.1, 0.2, -0.4, 0.5])
    C_lin = np.zeros((7, 4))
    for k in range(4):
        C_lin[3 + k, k] = 1.0
    d_lin = np.zeros(4)

    vals = {}
    for sense, sgn in (("upper", -1.0), ("lower", 1.0)):
        C = sgn * _msym(0, 2)
        prob = problem_from_dense([A], [C], b, C_lin=C_lin, d_lin=d_lin, device=device)
        res = solve(prob, dict(opts), device=device)
        # res.objective = -<C, X*> = -sgn * rho_AC^*
        vals[sense] = -sgn * res.objective
    return vals["lower"], vals["upper"]
