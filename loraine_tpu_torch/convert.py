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
from .problem import BlockGroup, SDPProblem
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
    """The port's SDPProblem from a host copy of a `loraine_tpu`
    SDPProblem (dense or rank-1 groups; fields as numpy arrays)."""
    device = resolve_device(device)
    if getattr(src, "nlin", 0):
        raise NotImplementedError(
            "the LP cone (nlin > 0) is not ported to loraine_tpu_torch yet; "
            "see ROADMAP.md Queue A item 8"
        )
    groups = []
    for g in src.groups:
        if getattr(g, "Avals", None) is not None:
            raise NotImplementedError(
                "sparse COO storage is not ported to loraine_tpu_torch yet; "
                "see ROADMAP.md Queue A item 10"
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
        ))
    return SDPProblem(
        groups=tuple(groups),
        b=_tensor(src.b, device, dtype),
        C_lin=None,
        d_lin=None,
        n=int(src.n),
        nlin=0,
        nlmi=int(src.nlmi),
        b_const=float(src.b_const),
        sum_msizes=int(src.sum_msizes),
    )


def state_from_numpy(
    src: Any,
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float64,
) -> IPMState:
    """The port's IPMState from a host copy of a `loraine_tpu` IPMState
    (the f64 fields X, S, y, sigma)."""
    device = resolve_device(device)
    if getattr(src, "X_lin", None) is not None:
        raise NotImplementedError(
            "LP-cone iterates are not ported to loraine_tpu_torch yet; "
            "see ROADMAP.md Queue A item 8"
        )
    return IPMState(
        X=tuple(_tensor(X, device, dtype) for X in src.X),
        S=tuple(_tensor(S, device, dtype) for S in src.S),
        y=_tensor(src.y, device, dtype),
        X_lin=None,
        S_lin=None,
        sigma=_tensor(src.sigma, device, dtype),
    )
