"""Double-double (compensated float64-pair) arithmetic primitives. Port of
`loraine_tpu/ops/dd.py` (`DD`, `two_sum`, `two_prod`, `dd_add`, `dd_neg`,
`dd_mul_f64`, `dd_sum`, `dd_dot`, `dd_matvec`, `dd_to_f64`).

A value is the unevaluated sum ``hi + lo`` with ``|lo| <= ulp(hi)/2``, ~32
significant digits: the stand-in for the reference's MultiFloats
`Float64x2` (`src/Solvers.jl:10`, `README.md:37-54`). Built from the
classical error-free transforms (Knuth TwoSum, Dekker split/TwoProd).

The transforms are exact only if every ``+ - *`` rounds once. Eager torch
ops do, on the CPU and on CUDA: each is its own kernel. What would break
them is contraction of ``a*b + c`` into one rounding, as torch.compile,
fused ops (``addcmul``, ``addcdiv``, ``torch.add(..., alpha=)``, ``lerp``,
``addmm``/``baddbmm`` with ``beta``/``alpha``) or a hand-written kernel
under nvcc's FMA contraction do. So this module, `ops/ozaki.py`,
`ops/dd_linalg.py` and the dd branches of `ipm/step.py` use two-operand
``+ - * /`` only, and nothing in the package compiles them.

The ``0.0 * b`` terms are the JAX package's fold-blockers against the
XLA:CPU algebraic simplifier. Eager torch has no simplifier, so here they
are harmless: ``0.0 * b`` is a signed zero, and adding it changes at most
the sign of a zero. They stay so that results are bitwise equal to the JAX
package's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = [
    "DD",
    "two_sum",
    "two_prod",
    "dd_add",
    "dd_mul_f64",
    "dd_neg",
    "dd_sum",
    "dd_dot",
    "dd_matvec",
    "dd_to_f64",
]

_SPLIT = 134217729.0  # 2**27 + 1, Dekker splitter for binary64


class DD(NamedTuple):
    """Unevaluated hi+lo pair; ``hi`` carries the leading 53 bits."""

    hi: torch.Tensor
    lo: torch.Tensor


def two_sum(a: torch.Tensor, b: torch.Tensor) -> DD:
    """Knuth TwoSum: s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = (s - a) + 0.0 * b
    e = (a - (s - bb)) + (b - bb)
    return DD(s, e)


def _split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor) -> DD:
    """Dekker TwoProd: p + e == a * b exactly, p = fl(a * b)."""
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return DD(p, e)


def _renorm(hi: torch.Tensor, lo: torch.Tensor) -> DD:
    s = hi + lo
    t = (s - hi) + 0.0 * lo
    return DD(s, lo - t)


def dd_add(x: DD, y: DD) -> DD:
    """Full dd + dd (Dekker add22, ~11 flops)."""
    s = two_sum(x.hi, y.hi)
    t = two_sum(x.lo, y.lo)
    c = s.lo + t.hi
    v = _renorm(s.hi, c)
    w = t.lo + v.lo
    return _renorm(v.hi, w)


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_mul_f64(x: DD, a: torch.Tensor) -> DD:
    """dd * f64."""
    p = two_prod(x.hi, a)
    return _renorm(p.hi, p.lo + x.lo * a)


def dd_sum(x: DD, axis: int = -1) -> DD:
    """Reduce a dd array along ``axis`` with a pairwise tree of dd adds
    (~u^2 accumulation error; the odd element folds into the first slot),
    in the JAX package's order, so the result is bitwise its."""
    hi = x.hi.movedim(axis, -1)
    lo = x.lo.movedim(axis, -1)
    n = hi.shape[-1]
    while n > 1:
        half = n // 2
        acc = dd_add(DD(hi[..., :half], lo[..., :half]),
                     DD(hi[..., half : 2 * half], lo[..., half : 2 * half]))
        if n % 2:
            first = dd_add(DD(acc.hi[..., :1], acc.lo[..., :1]),
                           DD(hi[..., -1:], lo[..., -1:]))
            hi = torch.cat([first.hi, acc.hi[..., 1:]], dim=-1)
            lo = torch.cat([first.lo, acc.lo[..., 1:]], dim=-1)
        else:
            hi, lo = acc.hi, acc.lo
        n = half
    return DD(hi[..., 0], lo[..., 0])


def dd_dot(a: torch.Tensor, b: torch.Tensor) -> DD:
    """Dot product in twice working precision (Ogita-Rump-Oishi dot2 class):
    TwoProd each term, dd-tree-sum the results, over the last axis."""
    a, b = torch.broadcast_tensors(a, b)
    return dd_sum(two_prod(a, b), axis=-1)


def dd_matvec(H: torch.Tensor, x: torch.Tensor) -> DD:
    """H @ x with dd accumulation: [n, n] @ [n] -> dd [n]."""
    return dd_dot(H, x[None, :])


def dd_to_f64(x: DD) -> torch.Tensor:
    return x.hi + x.lo
