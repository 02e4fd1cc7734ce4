"""Mixed-precision symmetric eigendecomposition: f32 Jacobi seed + f64
GEMM-only refinement. Port of `loraine_tpu/ops/eigh.py` (`eigh_mixed` with
the kernel seed, and `eigh_backend_for`).

The XLA-level Jacobi (`eigh_jacobi`), the QDWH seeds and the Lanczos bound
of the JAX package are not ported yet (ROADMAP.md Queue A item 13).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .jacobi import eigh_jacobi_f32

__all__ = ["eigh_mixed", "eigh_backend_for"]


def eigh_backend_for(backend: str, m: int) -> str:
    """Resolve the eigensolver backend. In the port 'auto' is the kernel
    route ('pallas') on every device: on a CPU tensor it runs the kernel's
    plain version, so CPU and card runs follow the same algorithm."""
    return "pallas" if backend == "auto" else backend


def eigh_mixed(
    M: torch.Tensor,
    gap_rel: float = 1e-6,
    refine_iters: int = 2,
    seed: str = "pallas",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 Jacobi eigenbasis (B1, `ops/jacobi.py`) refined to f64 by
    first-order eigenvector perturbation (`loraine_tpu/ops/eigh.py:149-227`).

    With the Rayleigh matrix M2 = V^T M V (nearly diagonal),

        v_j <- v_j + sum_{i != j} M2[i,j] / (d_j - d_i) * v_i

    for all pairs at once, then Newton-Schulz re-orthonormalization. Pairs
    closer than ``gap_rel * ||M||`` are skipped (any orthonormal basis of
    such a cluster's f32-accurate invariant subspace is valid). Eigenvalues
    come from f64 Rayleigh quotients.

    Returns (lam [nb, m] ascending, V [nb, m, m]) in M.dtype.
    """
    if seed != "pallas":
        raise NotImplementedError(
            f"eigh_mixed seed={seed!r} is not ported to loraine_tpu_torch "
            "yet; see ROADMAP.md Queue A item 13"
        )
    nb, m, _ = M.shape
    dtype = M.dtype
    eye = torch.eye(m, dtype=dtype, device=M.device)

    # Shift by the diagonal mean BEFORE casting: IPM scaling matrices have
    # tightly clustered spectra, and f32 then resolves the residual's
    # spread instead of the whole norm.
    c = torch.diagonal(M, dim1=-2, dim2=-1).mean(-1)  # [nb]
    D_ = M - c[:, None, None] * eye
    scale = D_.abs().sum(-1).amax(-1).clamp_min(1e-300)  # >= ||Delta||_2

    _, V32 = eigh_jacobi_f32(D_)
    V = V32.to(dtype)
    M = D_  # refine against the shifted matrix; shift restored at the end

    def orth(V):
        # two Newton-Schulz steps: ||C||^2 -> ~1e-8 -> 1e-16
        for _ in range(2):
            VtV = V.mT @ V
            V = V @ (1.5 * eye - 0.5 * VtV)
        return V

    V = orth(V)
    for _ in range(refine_iters):
        MV = M @ V
        M2 = V.mT @ MV
        d = torch.diagonal(M2, dim1=-2, dim2=-1)  # [nb, m]
        E = M2 - d[:, None, :] * eye
        den = d[:, None, :] - d[:, :, None]  # den[i, j] = d_j - d_i
        ok = den.abs() > gap_rel * scale[:, None, None]
        C = torch.where(ok, E / torch.where(ok, den, torch.ones_like(den)),
                        torch.zeros_like(E))
        # trust region: perturbation theory is only valid for small C
        C = C.clamp(-0.3, 0.3)
        V = orth(V + V @ C)

    MV = M @ V
    lam = c[:, None] + (V * MV).sum(-2)
    order = torch.argsort(lam, dim=-1, stable=True)
    lam = torch.gather(lam, -1, order)
    V = torch.gather(V, -1, order[:, None, :].expand(nb, m, m))
    return lam, V
