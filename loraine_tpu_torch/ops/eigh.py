"""Batched symmetric eigendecompositions and the Lanczos lambda_min bound.
Port of `loraine_tpu/ops/eigh.py` (`round_robin_pairs`, `eigh_jacobi`,
`eigh_mixed`, `eigmin_lanczos`).

The backends of ``eigh_backend``:

  'pallas'  `eigh_mixed(seed='pallas')`: the B1 kernel's f32 Jacobi seed
            (`ops/jacobi.py`, CUDA C++ in `csrc/jacobi.cu`) refined to f64;
  'mixed'   `eigh_mixed(seed='xla32')`: the library's f32 `eigh` (cuSOLVER
            on the card, LAPACK on the CPU) as the seed, refined to f64;
  'jacobi'  `eigh_jacobi`: the f64 parallel cyclic Jacobi as eager tensor
            ops, (m-1) rounds per sweep of ~45 small ops each;
  'xla'     the library's f64 `eigh`.

'auto' resolves to 'pallas' on every device (`Options.resolved`; the JAX
package's `eigh_backend_for` picks 'pallas' on the TPU and 'jacobi'/'mixed'
by size on the CPU, `loraine_tpu/ops/eigh.py:53-58`): on a CPU tensor B1
runs its plain version, so CPU and card runs follow the same algorithm.
None of 'mixed', 'jacobi', 'xla' or `eigmin_lanczos` reaches a Pallas kernel
in the JAX package (XLA loops, GEMMs and `jnp.linalg.eigh`), so none has a
kernel here either.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .jacobi import eigh_jacobi_f32
from .linalg import eigh_or_nan

__all__ = [
    "round_robin_pairs",
    "eigh_jacobi",
    "eigh_mixed",
    "eigmin_lanczos",
]


@functools.lru_cache(maxsize=None)
def round_robin_pairs(m: int) -> np.ndarray:
    """Static round-robin schedule: pairs[r] lists m/2 disjoint (p, q) pairs
    covering all indices; over m-1 rounds every unordered pair appears once.
    m must be even (odd sizes are padded by the caller). int32
    [m-1, 2, m/2], read-only."""
    assert m % 2 == 0
    others = list(range(1, m))
    rounds = []
    for _ in range(m - 1):
        lineup = [0] + others
        rounds.append((lineup[: m // 2], lineup[m // 2 :][::-1]))
        others = others[1:] + others[:1]
    arr = np.array(rounds, dtype=np.int32)
    arr.flags.writeable = False
    return arr


def _default_sweeps(m: int) -> int:
    """quadratic convergence: ~log2(m) + margin sweeps reach f64 precision."""
    return int(np.clip(np.ceil(np.log2(max(m, 4))) + 6, 8, 16))


@functools.lru_cache(maxsize=None)
def _round_tables(m: int):
    """Per round r of `round_robin_pairs(m)`: p and q [R, m/2], the partner
    of every index [R, m], and the position of every index in cat(p, q)
    [R, m] (int64 numpy)."""
    pairs = round_robin_pairs(m).astype(np.int64)
    nrounds = pairs.shape[0]
    partner = np.empty((nrounds, m), dtype=np.int64)
    pos = np.empty((nrounds, m), dtype=np.int64)
    half = np.arange(m // 2)
    for r in range(nrounds):
        p, q = pairs[r, 0], pairs[r, 1]
        partner[r, p], partner[r, q] = q, p
        pos[r, p], pos[r, q] = half, half + m // 2
    return pairs[:, 0], pairs[:, 1], partner, pos


def _eigh_jacobi_impl(M: torch.Tensor, sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel cyclic Jacobi on [nb, m, m], m even
    (`loraine_tpu/ops/eigh.py:_eigh_jacobi_impl`). Each round rotates the
    m/2 disjoint pairs (p, q) of the round-robin schedule at once: rows,
    then columns, then the eigenvector columns. A row i with partner j
    becomes cf_i A_i + sf_i A_j, with cf = c on both rows of a pair and
    sf = -s on p's row, +s on q's row: the JAX package's c P - s Q and
    s P + c Q, each product and sum rounded once as there."""
    nb, m, _ = M.shape
    dtype, dev = M.dtype, M.device
    p_t, q_t, part_t, pos_t = (torch.as_tensor(t, device=dev) for t in _round_tables(m))
    A = M.clone()
    V = torch.eye(m, dtype=dtype, device=dev).expand(nb, m, m).clone()
    # the rotate-or-not decision comes first and the denominator is
    # sanitized, so no inf/NaN is ever produced
    eps = float(torch.finfo(dtype).eps)
    for _ in range(sweeps):
        for r in range(m - 1):
            p, q, part, pos = p_t[r], q_t[r], part_t[r], pos_t[r]
            d = torch.diagonal(A, dim1=-2, dim2=-1)
            app, aqq, apq = d[:, p], d[:, q], A[:, p, q]  # [nb, m/2]
            active = apq.abs() > eps * 1e-3 * (app.abs() + aqq.abs() + 1.0)
            apq_safe = torch.where(active, apq, 1.0)
            tau = (aqq - app) / (2.0 * apq_safe)
            sgn = torch.where(tau >= 0, 1.0, -1.0)
            t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(active, t, 0.0)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            cf = torch.cat([c, c], dim=1)[:, pos]  # [nb, m]
            sf = torch.cat([-s, s], dim=1)[:, pos]
            # rows p, q: A <- J^T A;  cols p, q: A <- A J;  V <- V J
            A = cf[:, :, None] * A + sf[:, :, None] * A[:, part, :]
            A = A * cf[:, None, :] + A[:, :, part] * sf[:, None, :]
            V = V * cf[:, None, :] + V[:, :, part] * sf[:, None, :]
    lam = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(lam, dim=-1, stable=True)
    lam = torch.gather(lam, -1, order)
    V = torch.gather(V, -1, order[:, None, :].expand(nb, m, m))
    return lam, V


def eigh_jacobi(M: torch.Tensor, sweeps: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a batch of symmetric matrices [nb, m, m] by the
    f64 (M.dtype) parallel cyclic Jacobi (`loraine_tpu/ops/eigh.py:304-322`).

    Returns (eigenvalues ascending [nb, m], eigenvectors [nb, m, m]) with
    M = V diag(lam) V^T. Odd m gets a decoupled pad index (zero coupling,
    a sentinel diagonal beyond the spectrum of every matrix, sorted last)."""
    nb, m, _ = M.shape
    if sweeps is None:
        sweeps = _default_sweeps(m)
    if m % 2 == 0:
        return _eigh_jacobi_impl(M, sweeps)
    big = M.abs().sum(-1).amax() + 1.0  # beyond the spectrum
    Mp = M.new_zeros((nb, m + 1, m + 1))
    Mp[:, :m, :m] = M
    Mp[:, m, m] = big
    lam, V = _eigh_jacobi_impl(Mp, sweeps)
    return lam[:, :m], V[:, :m, :m]


def eigh_mixed(
    M: torch.Tensor,
    gap_rel: float = 1e-6,
    refine_iters: int = 2,
    seed: str = "xla32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """An f32 eigenbasis refined to M.dtype by first-order eigenvector
    perturbation (`loraine_tpu/ops/eigh.py:149-227`). ``seed``: 'xla32',
    the library's f32 `eigh` of the shifted matrix, or 'pallas', the B1
    Jacobi kernel (`ops/jacobi.py`).

    With the Rayleigh matrix M2 = V^T M V (nearly diagonal),

        v_j <- v_j + sum_{i != j} M2[i,j] / (d_j - d_i) * v_i

    for all pairs at once, then Newton-Schulz re-orthonormalization. Pairs
    closer than ``gap_rel * ||M||`` are skipped (any orthonormal basis of
    such a cluster's f32-accurate invariant subspace is valid). Eigenvalues
    come from Rayleigh quotients in M.dtype.

    Returns (lam [nb, m] ascending, V [nb, m, m]) in M.dtype.
    """
    if seed not in ("xla32", "pallas"):
        raise ValueError(f"eigh_mixed seed must be 'xla32' or 'pallas', got {seed!r}")
    nb, m, _ = M.shape
    dtype = M.dtype
    eye = torch.eye(m, dtype=dtype, device=M.device)

    # Shift by the diagonal mean BEFORE casting: IPM scaling matrices have
    # tightly clustered spectra, and f32 then resolves the residual's
    # spread instead of the whole norm.
    c = torch.diagonal(M, dim1=-2, dim2=-1).mean(-1)  # [nb]
    D_ = M - c[:, None, None] * eye
    scale = D_.abs().sum(-1).amax(-1).clamp_min(1e-300)  # >= ||Delta||_2

    if seed == "pallas":
        _, V32 = eigh_jacobi_f32(D_)
    else:
        _, V32 = eigh_or_nan(D_.to(torch.float32))
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


def eigmin_lanczos(M: torch.Tensor, iters: int = 48) -> torch.Tensor:
    """Lower bound on the smallest eigenvalue of each symmetric matrix in a
    batch [nb, m, m] by Lanczos with full reorthogonalization
    (`loraine_tpu/ops/eigh.py:230-301`): min(iters, m) matvecs from the
    deterministic start vector sin(1.31 i + 0.7) + 0.01 (i + 1) / m, each
    reorthogonalized twice against every Lanczos vector, then `eigh_jacobi`
    of the tridiagonal matrix. Returns theta_min - |beta_k s_k| - 8 eps
    ||M||_inf (the Ritz residual bound and a rounding margin), [nb].

    A Ritz value bounds lambda_min from above only where the Krylov space
    holds the bottom eigenvector; with a fixed iteration cap nothing
    guarantees that, which is why step_eig='lanczos' keeps the Cholesky
    PSD probe (`ipm/step.py`)."""
    nb, m, _ = M.shape
    dtype, dev = M.dtype, M.device
    k = int(min(iters, m))

    i = torch.arange(m, dtype=dtype, device=dev)
    v0 = torch.sin(i * 1.31 + 0.7) + 0.01 * (i + 1.0) / m
    v0 = v0 / torch.linalg.norm(v0)

    Vb = M.new_zeros((nb, k, m))
    Vb[:, 0, :] = v0
    alpha = M.new_zeros((nb, k))
    beta = M.new_zeros((nb, k))  # beta[j] = ||r_j|| after step j
    for j in range(k):
        v = Vb[:, j, :]
        w = torch.einsum("bpq,bq->bp", M, v)
        alpha[:, j] = torch.einsum("bp,bp->b", v, w)
        # full reorthogonalization against all previous vectors, twice
        for _ in range(2):
            coeff = torch.einsum("bkp,bp->bk", Vb, w)
            w = w - torch.einsum("bk,bkp->bp", coeff, Vb)
        b = torch.linalg.norm(w, dim=-1)
        beta[:, j] = b
        if j + 1 < k:
            pos = b > 0
            Vb[:, j + 1, :] = torch.where(pos[:, None], w / torch.where(pos, b, 1.0)[:, None], 0.0)

    # tridiagonal T: diag alpha, off-diagonals beta[:-1]
    off = beta[:, :-1]
    T = torch.diag_embed(alpha) + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)
    lam, U = eigh_jacobi(T)
    resid = (beta[:, -1] * U[:, -1, 0]).abs()
    scale = M.abs().sum(-1).amax(-1)
    eps = float(torch.finfo(dtype).eps)
    return lam[:, 0] - resid - 8.0 * eps * scale
