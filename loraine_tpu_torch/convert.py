"""Carry problems and iterates across from the JAX reference package.

No JAX counterpart. The caller fetches the JAX objects to the host first
(``jax.device_get(problem)`` returns the same dataclass with numpy arrays),
so this module reads plain attributes and numpy arrays and never imports
jax. With it a test hands both packages the same problem and the same
mid-solve iterate.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .ipm.state import IPMState
from .problem import BlockGroup, SDPProblem, adjoint_layout, held, lp_cone
from .utils.device import resolve_device

__all__ = ["problem_from_numpy", "state_from_numpy"]


def _tensor(x, device: torch.device, dtype: torch.dtype):
    if x is None:
        return None
    return torch.as_tensor(np.array(x)).to(device=device, dtype=dtype)


def problem_from_numpy(
    src: Any,
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float64,
) -> SDPProblem:
    """The port's SDPProblem from a host copy of a `loraine_tpu` SDPProblem
    (dense, rank-1 or sparse groups, and the LP cone; fields as numpy
    arrays). Sparse groups get their `AdjLayout` built here."""
    device = resolve_device(device)
    groups = []
    for g in src.groups:
        sparse = {}
        if getattr(g, "Avals", None) is not None:
            rows, cols, vals = (np.array(x) for x in (g.Arows, g.Acols, g.Avals))
            sparse = dict(
                Arows=_tensor(rows, device, torch.int64),
                Acols=_tensor(cols, device, torch.int64),
                Avals=_tensor(vals, device, dtype),
                adj=adjoint_layout(rows, cols, vals, int(g.m), dtype, device),
            )
        groups.append(BlockGroup(
            C=_tensor(g.C, device, dtype),
            A=_tensor(g.A, device, dtype),
            B=_tensor(g.B, device, dtype),
            Bsgn=_tensor(g.Bsgn, device, dtype),
            m=int(g.m),
            nb=int(g.nb),
            orig_sizes=tuple(g.orig_sizes),
            orig_indices=tuple(g.orig_indices),
            data_norms=tuple(g.data_norms),
            C_norms=tuple(g.C_norms),
            **sparse,
        ))
    n = int(src.n)
    lp = (None, None, None, 0.0)
    if src.C_lin is not None:
        lp = lp_cone(np.array(src.C_lin), np.array(src.d_lin), n, dtype, device)
    C_lin, d_lin, row_norms, d_norm = lp
    b_host = held(np.array(src.b), dtype)
    return SDPProblem(
        groups=tuple(groups),
        b=torch.as_tensor(b_host).to(device=device),
        C_lin=C_lin,
        d_lin=d_lin,
        n=n,
        nlin=int(src.nlin),
        nlmi=int(src.nlmi),
        b_const=float(src.b_const),
        sum_msizes=int(src.sum_msizes),
        b_host=b_host,
        C_lin_row_norms=row_norms,
        d_lin_norm=d_norm,
    )


def state_from_numpy(
    src: Any,
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float64,
) -> IPMState:
    """The port's IPMState from a host copy of a `loraine_tpu` IPMState: the
    f64 fields X, S, y, X_lin, S_lin, sigma and, where the source has them
    (precision='dd2'), the tails X_lo, S_lo, y_lo, X_lin_lo, S_lin_lo."""
    device = resolve_device(device)

    def blocks(xs):
        return None if xs is None else tuple(_tensor(x, device, dtype) for x in xs)

    return IPMState(
        X=blocks(src.X),
        S=blocks(src.S),
        y=_tensor(src.y, device, dtype),
        X_lin=_tensor(src.X_lin, device, dtype),
        S_lin=_tensor(src.S_lin, device, dtype),
        sigma=_tensor(src.sigma, device, dtype),
        X_lo=blocks(getattr(src, "X_lo", None)),
        S_lo=blocks(getattr(src, "S_lo", None)),
        y_lo=_tensor(getattr(src, "y_lo", None), device, dtype),
        X_lin_lo=_tensor(getattr(src, "X_lin_lo", None), device, dtype),
        S_lin_lo=_tensor(getattr(src, "S_lin_lo", None), device, dtype),
    )
