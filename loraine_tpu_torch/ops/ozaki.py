"""Accurate (double-double class) matrix multiply by the Ozaki scheme. Port
of `loraine_tpu/ops/ozaki.py` (`pow2_int`, `ceil_log2`, `_slice_params`,
`slice_operand`, `acc_matmul`, `acc_matvec`, `dd_gemm_hi_lo`).

Computes ``A @ B`` to ~``bits`` significant bits with standard f64 GEMMs
plus elementwise double-double accumulation (Ozaki-Ogita-Oishi-Rump
error-free matrix-product transform): each operand is cut into
exponent-aligned slices of ``beta`` significand bits, with
``2*beta + ceil(log2(k)) <= 53`` (k = contraction length), so every partial
product ``A_p @ B_q`` is EXACT in f64 whatever order the GEMM sums in (each
output element is a sum of <= 2^w grid-aligned products of <= 2*beta
bits). The partials are `torch.matmul` (cuBLAS on the card, where f64 GEMMs
run on the tensor cores; the CPU BLAS here) and accumulate in dd, largest
first; pairs with ``(p+q)*beta > bits`` are dropped, bounding the relative
error by ~2^-bits of the |A||B| scale. Slicing, truncation and the order of
the dd adds are the JAX package's, so the result is its bit for bit
wherever both compute the same slice exponents (see `ceil_log2`).
"""
from __future__ import annotations

import math

import torch

from .dd import DD, dd_add, two_sum

__all__ = [
    "slice_operand",
    "acc_matmul",
    "acc_matvec",
    "dd_gemm_hi_lo",
    "pow2_int",
    "ceil_log2",
]

# Fiber-max clamp for slice_operand (`ozaki.py:39-45`): keeps every exponent
# handed to pow2_int within +-1024; fibers below 2**-400 contribute < 2**-800
_TINY = 2.0**-400


def pow2_int(e: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """EXACT 2**e for an integer tensor e, by repeated squaring (every
    product of powers of two is exact). Domain [-1022, 1023], the normal f64
    range; arguments outside are clamped to it, as in the JAX package (where
    XLA flushes f64 subnormals; torch keeps them, which inside the clamp
    makes no difference)."""
    neg = e < 0
    k = e.abs().to(torch.int32)
    k = torch.minimum(k, torch.where(neg, 1022, 1023).to(torch.int32))
    two = torch.where(neg, 0.5, 2.0).to(dtype)
    result = torch.ones(e.shape, dtype=dtype, device=e.device)
    base = two
    for j in range(10):  # k < 1024
        result = torch.where((k & 1) == 1, result * base, result)
        k = k >> 1
        if j < 9:  # largest base needed: two**512
            base = base * base
    return result


def ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """int32 e with 2**e >= x (one bit of headroom against log2 rounding);
    x must be positive. At an exact power of two XLA's f64 log2 can come out
    one ulp low (floor one less) where torch's is exact, so there the two
    packages pick slice exponents one apart: both valid slicings, whose
    truncated products differ below 2^-100 of the scale."""
    return (torch.floor(torch.log2(x)) + 2.0).to(torch.int32)


def _slice_params(k: int, bits: int):
    w = max(1, math.ceil(math.log2(max(2, k))))
    beta = (53 - w) // 2
    if beta < 10:
        raise ValueError(f"contraction length {k} too large for Ozaki slicing")
    # each operand covered to ~bits, so that the dropped residual times the
    # other operand stays below the target
    nsl = max(2, math.ceil(bits / beta))
    return beta, nsl


def slice_operand(X: torch.Tensor, axis: int, beta: int, s: int):
    """Split X into s exponent-aligned slices of <= beta significand bits
    each (per fiber along ``axis``); X == sum(slices) + dropped residual.
    Round-to-grid by an exact power-of-two scaling; `torch.round` rounds
    half to even, as `jnp.round` does."""
    mx = X.abs().amax(dim=axis, keepdim=True)
    e = ceil_log2(torch.clamp(mx, min=_TINY))  # 2**e in [2*mx, 4*mx]
    slices = []
    R = X
    for i in range(s):
        sigma = pow2_int(e - beta * (i + 1), X.dtype)
        inv = pow2_int(beta * (i + 1) - e, X.dtype)
        q = torch.round(R * inv) * sigma  # multiple of sigma, <= beta bits
        slices.append(q)
        R = R - q  # exact
    return slices


def acc_matmul(A: torch.Tensor, B: torch.Tensor, bits: int = 106) -> DD:
    """A [..., m, k] @ B [..., k, n] -> DD [..., m, n], accurate to ~2^-bits
    relative to the |A| |B| scale; batch dims broadcast as `torch.matmul`."""
    k = A.shape[-1]
    if B.shape[-2] != k:
        raise ValueError(f"contraction mismatch {tuple(A.shape)} @ {tuple(B.shape)}")
    beta, s = _slice_params(k, bits)
    Asl = slice_operand(A, -1, beta, s)
    Bsl = slice_operand(B, -2, beta, s)
    acc = None
    # largest partials first: accumulate in increasing p+q
    for t in range(2 * s - 1):
        if (t + 2) * beta > bits + 2 * beta:  # truncate sub-target terms
            break
        for p in range(s):
            q = t - p
            if q < 0 or q >= s:
                continue
            part = Asl[p] @ Bsl[q]  # EXACT f64 GEMM by construction
            if acc is None:
                acc = DD(part, torch.zeros_like(part))
            else:
                acc = dd_add(acc, DD(part, torch.zeros_like(part)))
    return acc


def acc_matvec(A: torch.Tensor, x: torch.Tensor, bits: int = 106) -> DD:
    """A [..., m, k] @ x [..., k] -> DD [..., m]."""
    r = acc_matmul(A, x[..., None], bits=bits)
    return DD(r.hi[..., 0], r.lo[..., 0])


def dd_gemm_hi_lo(Ahi: torch.Tensor, Alo: torch.Tensor, B: torch.Tensor,
                  bits: int = 106) -> DD:
    """(Ahi + Alo) @ B in dd: the accurate GEMM on the hi part plus a plain
    f64 GEMM for the lo part (its own rounding is ~u^2 of the total)."""
    r = acc_matmul(Ahi, B, bits=bits)
    s = two_sum(r.hi, Alo @ B)
    return DD(s.hi, s.lo + r.lo)
