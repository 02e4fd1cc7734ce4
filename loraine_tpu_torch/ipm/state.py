"""Solver iterate state and per-iteration statistics. Port of
`loraine_tpu/ipm/state.py`, with the dd2 tails.

The persistent iterate is (X, S, y, LP variables, sigma); directions,
scaling and residuals are local to one step (the reference keeps them as
fields on `MySolver`, `src/Solvers.jl:18-147`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class IPMState:
    X: Tuple[torch.Tensor, ...]  # per block group [nb, m, m]
    S: Tuple[torch.Tensor, ...]
    y: torch.Tensor  # [n]
    X_lin: Optional[torch.Tensor]  # [nlin] or None
    S_lin: Optional[torch.Tensor]
    sigma: torch.Tensor  # scalar
    # double-double tails (precision='dd2': the iterates are hi+lo pairs,
    # the stand-in for the reference's Float64x4-class solver,
    # `src/Solvers.jl:18`); None in every other mode
    X_lo: Optional[Tuple[torch.Tensor, ...]] = None
    S_lo: Optional[Tuple[torch.Tensor, ...]] = None
    y_lo: Optional[torch.Tensor] = None
    X_lin_lo: Optional[torch.Tensor] = None
    S_lin_lo: Optional[torch.Tensor] = None


@dataclasses.dataclass
class StepStats:
    """Per-iteration scalars (0-dim tensors on the problem's device); they
    drive the log table and the status decisions of the host loop."""

    obj: torch.Tensor  # -b^T y + b_const
    mu: torch.Tensor
    sigma: torch.Tensor
    err1: torch.Tensor
    err2: torch.Tensor
    err3: torch.Tensor
    err4: torch.Tensor
    err5: torch.Tensor
    err6: torch.Tensor
    dimacs: torch.Tensor
    alpha_min: torch.Tensor
    beta_min: torch.Tensor
    h_shifts: int  # Schur-Cholesky regularization shifts this iteration
    h_ok: bool  # Schur factorization succeeded
    nt_ok: torch.Tensor  # bool: NT scaling factorizations succeeded
    cg_iter_pre: torch.Tensor  # int32: CG iterations of the predictor solve (kit=1)
    cg_iter_cor: torch.Tensor  # int32: CG iterations of the corrector solve

    def to_host(self, mesh=None) -> dict:
        """All fields as Python numbers, with ONE device-to-host transfer for
        the tensor-valued ones. With a ``mesh`` (`parallel/mesh.py`) the
        values are global rank 0's on every rank, so every rank's host loop
        takes the same branch."""
        names = [f.name for f in dataclasses.fields(self)]
        tens = [n for n in names if isinstance(getattr(self, n), torch.Tensor)]
        vals = torch.stack([getattr(self, n).to(torch.float64) for n in tens])
        if mesh is not None:
            vals = mesh.agree(vals)
        vals = vals.cpu().tolist()
        out = {n: getattr(self, n) for n in names if n not in tens}
        out.update(zip(tens, vals))
        out["nt_ok"] = bool(out["nt_ok"])
        for k in ("cg_iter_pre", "cg_iter_cor"):
            out[k] = int(out[k])
        return out
