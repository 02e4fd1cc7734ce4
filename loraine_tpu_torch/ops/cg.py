"""Conjugate gradients, plain and preconditioned. Port of
`loraine_tpu/ops/cg.py` (`cg_plain`, `pcg`).

Replaces the reference's ConjugateGradients.jl dependency
(`src/predictor_corrector.jl:134,235`). Same recurrences, stopping rule
(||r||^2 > tol^2 ||b||^2 keeps iterating) and iteration cap as the JAX
package. PyTorch runs eagerly, so the stopping test is one host read per CG
iteration: correct on any device, slow on the card, which is why the card's
default route on the materialized path is the single-launch kernel of
`ops/pcg.py`. The iteration count comes back as an int32 tensor on the
vectors' device, so callers can add counts without a host read.
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

__all__ = ["pcg", "cg_plain"]

Scalar = Union[float, torch.Tensor]


def _count(it: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(it, dtype=torch.int32, device=like.device)


def cg_plain(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    tol: Scalar,
    maxiter: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpreconditioned CG (used on the split-preconditioned system
    Hp = Mli H Mli^T, which has the Krylov iterates of `pcg` on H with
    M = Mli^T Mli). Returns (x, iterations)."""
    rr = torch.dot(b, b)
    threshold2 = tol * tol * rr
    x, r, p = torch.zeros_like(b), b, b
    it = 0
    while it < maxiter and bool(rr > threshold2):
        Ap = matvec(p)
        alpha = rr / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = torch.dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        it += 1
    return x, _count(it, b)


def pcg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor],
    tol: Scalar,
    maxiter: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve A x = b with preconditioned CG. Returns (x, iterations)."""
    rr = torch.dot(b, b)
    threshold2 = tol * tol * rr
    x, r = torch.zeros_like(b), b
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    it = 0
    while it < maxiter and bool(rr > threshold2):
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rr, rz_new = torch.stack([r, z]) @ r  # [rr, rz] in one reduction
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, _count(it, b)
