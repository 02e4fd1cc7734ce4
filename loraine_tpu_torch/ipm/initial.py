"""Initial point heuristics. Port of `loraine_tpu/ipm/initial.py`.

Two strategies matching the reference (`src/initial_point.jl:17-81`):
  initpoint = 0: X = I, S = n * I (n = number of variables), LP vars = 1.
  initpoint = 1: SDPT3-like norm-scaled identity start.
Built on the host in numpy from the host values the build keeps
(`BlockGroup.data_norms`/`C_norms`, `SDPProblem.b_host`, `C_lin_row_norms`,
`d_lin_norm`), with no read of device data, and moved to the problem's
device once. On a sharded problem each rank builds its own blocks from the
whole problem's norms (they stay whole, `parallel/mesh.py`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Options
from ..problem import SDPProblem
from .state import IPMState

__all__ = ["initial_point", "INITIAL_SIGMA", "TAU", "EXPON"]

# Reference constants `src/initial_point.jl:5-9`.
INITIAL_SIGMA = 3.0
TAU = 0.95
EXPON = 3.0


def initial_point(problem: SDPProblem, opts: Options) -> IPMState:
    dtype, device = problem.b.dtype, problem.device
    n = problem.n
    b2 = 1.0 + np.abs(problem.b_host)
    norm_b2 = float(np.linalg.norm(b2))

    def dev(x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    Xs, Ss = [], []
    for g in problem.groups:
        m = g.m
        eye = np.eye(m)[None]
        if opts.initpoint == 0:
            eps = np.ones((g.nb,))
            eta = np.full((g.nb,), float(n))
        else:
            own = slice(*g.shard.blocks) if g.shard is not None else slice(None)
            fro_A = np.asarray(g.data_norms)[own]  # [nb], precomputed at build
            f = norm_b2 / (1.0 + fro_A)
            eps = np.sqrt(m) * np.maximum(1.0, np.sqrt(m) * f)
            fro_C = np.asarray(g.C_norms)[own]
            mf = np.maximum(f, fro_C)
            mf = (1.0 + mf) / np.sqrt(m)
            eta = np.sqrt(m) * np.maximum(1.0, mf)
        Xs.append(dev(eps[:, None, None] * eye))
        Ss.append(dev(eta[:, None, None] * eye))

    X_lin = S_lin = None
    if problem.nlin > 0:
        if opts.initpoint == 0:
            epss = etaa = 1.0
        else:
            row_norms = problem.C_lin_row_norms  # of C_lin's rows, per variable j
            p = b2 / (1.0 + row_norms)
            epss = max(1.0, float(p.max())) if p.size else 1.0
            mf = max(float(row_norms.max()) if row_norms.size else 0.0, problem.d_lin_norm)
            etaa = max(1.0, mf / np.sqrt(problem.nlin))
        X_lin = dev(np.full(problem.nlin, epss))
        S_lin = dev(np.full(problem.nlin, etaa))

    return IPMState(
        X=tuple(Xs),
        S=tuple(Ss),
        y=dev(np.zeros(n)),
        X_lin=X_lin,
        S_lin=S_lin,
        sigma=dev(np.asarray(INITIAL_SIGMA)),
    )
