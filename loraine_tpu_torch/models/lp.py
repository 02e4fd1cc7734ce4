"""Pure linear programs through the LP cone (no LMI blocks) — the nlmi = 0
path (reference behavior: `examples/k.jl`, which solves max 2x s.t.
1 <= x <= 2 and checks objective 4 and shadow prices 0 / 2).

Dual form: max b^T y  s.t.  C_lin^T y <= d_lin. The LP-cone primal variables
X_lin are the constraint duals (shadow prices). Port of
`loraine_tpu/models/lp.py`.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..problem import SDPProblem, problem_from_dense

__all__ = ["lp_problem"]


def lp_problem(b: np.ndarray, C_lin: np.ndarray, d_lin: np.ndarray,
               device: Union[str, torch.device] = "cuda") -> SDPProblem:
    """max b'y s.t. C_lin^T y <= d_lin  (C_lin: [n, nlin])."""
    return problem_from_dense([], [], b, C_lin=C_lin, d_lin=d_lin, device=device)
