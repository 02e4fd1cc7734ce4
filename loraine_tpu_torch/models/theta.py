"""Lovasz theta-function SDP (the family behind theta1/thetaG11).

    theta(G) = max <J, X>  s.t.  tr(X) = 1,  X_ij = 0 for (i,j) in E,  X >= 0

Primal-form encoding: C = -J, A_1 = I (b_1 = 1), A_e = (E_ij + E_ji)/2
(b_e = 0). theta(G) = Result.objective of the solve. Port of
`loraine_tpu/models/theta.py`.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..problem import SDPProblem, problem_from_dense

__all__ = ["lovasz_theta_problem"]


def lovasz_theta_problem(
    nv: int, edges: Sequence[Tuple[int, int]], pad_multiple: int = 8,
    device: Union[str, torch.device] = "cuda",
) -> SDPProblem:
    n = 1 + len(edges)
    A = np.zeros((n, nv, nv))
    A[0] = np.eye(nv)
    for k, (i, j) in enumerate(edges):
        A[k + 1, i, j] = 0.5
        A[k + 1, j, i] = 0.5
    C = -np.ones((nv, nv))
    b = np.zeros(n)
    b[0] = 1.0
    return problem_from_dense([A], [C], b, pad_multiple=pad_multiple, device=device)
