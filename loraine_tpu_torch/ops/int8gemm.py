"""f64-accurate matrix product from exact int8 products (the integer Ozaki
scheme). Port of `loraine_tpu/ops/int8gemm.py` (`matmul_f64_mxu`,
`INT8_BETA`, `_slice_int8`, `_num_slices`).

Each operand is cut into s int8 slices on an exponent-aligned grid per
fiber (A per row, B per column):

    A[i, :] = 2^e_i sum_p 2^(-6(p+1)) Q_p[i, :]  (+ a residual < 2^(e_i - 6s))

and the product is rebuilt from the exact partial products Q_p(A) Q_q(B),
those with equal t = p + q summed first and weighted by 2^(-6(t+2)). Every
operation is exact except the sum over t, taken in ascending t, so the
result is at least as accurate as an f64 GEMM (`tests/test_int8gemm.py`'s
contract) and this module equals the JAX function bit for bit wherever the
two compute the same fiber exponents e (see `ozaki.ceil_log2`).

Routes, as in `ops/jacobi.py`: `matmul_f64_mxu` runs the plain version
(`matmul_f64_int8_plain`: the JAX function step by step, each pair's
product an f64 matmul of the int8-valued slices, exact since every partial
stays below 2^28) for CPU tensors, and for CUDA tensors the two
hand-written kernels of `csrc/int8gemm.cu` (built with nvcc for sm_90a at
first use), with no fallback:

  O1 `ozaki_slice_s8_cuda` <- `int8gemm.py::_slice_int8`
  O2 `ozaki_gemm_s8_cuda`  <- `int8gemm.py::matmul_f64_mxu`'s pair loop

Neither is a Pallas kernel in the JAX package (XLA ops there). The wrapper
computes the fiber maxima and exponents in torch with the plain version's
own code, so the kernels never take a log2 of their own, and the kernels
equal the plain version bit for bit. On this card the int8 tensor cores'
1,979 TOPS do not make up for the 76 products (s = 11): the route is
expected to lose to the library's f64 GEMM, and stays opt-in
(``gemm_backend='int8'``), as in the JAX package.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import torch

from .ozaki import ceil_log2, pow2_int

__all__ = [
    "matmul_f64_mxu",
    "matmul_f64_int8_plain",
    "matmul_f64_int8_cuda",
    "ozaki_slice_s8_cuda",
    "ozaki_gemm_s8_cuda",
    "pair_schedule",
    "fiber_exponents",
    "INT8_BETA",
    "K_MAX",
]

INT8_BETA = 6  # payload bits per slice: |q| <= 33 fits int8 with headroom
_TINY = 2.0**-1000
K_MAX = 1 << 17  # longest contraction whose partials stay exact in int32


def _num_slices(bits: int) -> int:
    return int(math.ceil(bits / INT8_BETA)) + 1


def pair_schedule(s: int, bits: int) -> List[Tuple[int, List[int]]]:
    """[(t, [p, ...]), ...]: the slice pairs (p, t - p) of each weight t,
    in the order both versions sum them (`int8gemm.py:82-99`)."""
    tmax = min(2 * s - 2, _num_slices(bits))
    return [(t, list(range(max(0, t - s + 1), min(s, t + 1)))) for t in range(tmax + 1)]


def fiber_exponents(X: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(e int32, 2^e f64), keepdim along ``dim``: 2^e in [2 mx, 4 mx] for the
    fiber max mx (clamped to 2^-1000), as `int8gemm.py:51-53`."""
    mx = X.abs().amax(dim=dim, keepdim=True)
    e = ceil_log2(torch.clamp_min(mx, _TINY))
    return e, pow2_int(e)


def _slice_int8(X: torch.Tensor, axis: int, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """O1's plain version: (slices int8 [s, ...], scale f64 broadcastable to
    X), X = sum_p scale 2^(-6(p+1)) slices[p] + residual. Every step is
    exact: q is an integer of at most 7 bits and the factors are powers of
    two."""
    e, scale = fiber_exponents(X, axis)
    R = X
    out = []
    for p in range(s):
        inv = pow2_int(INT8_BETA * (p + 1) - e)
        sigma = pow2_int(e - INT8_BETA * (p + 1))
        q = torch.round(R * inv)
        out.append(q.to(torch.int8))
        R = R - q * sigma
    return torch.stack(out), scale


def _ozaki_sum(Asl: torch.Tensor, Bsl: torch.Tensor, a_scale: torch.Tensor,
               b_scale: torch.Tensor, bits: int) -> torch.Tensor:
    """O2's plain version on A's slices [s, ..., n, k] and B's [s, ..., k, c]:
    each pair's product an f64 matmul (exact), the pairs of one t summed in
    ascending p (exact), then out + acc_t 2^(-6(t+2)) in ascending t."""
    Af, Bf = Asl.to(torch.float64), Bsl.to(torch.float64)
    out = None
    for t, ps in pair_schedule(Asl.shape[0], bits):
        acc = None
        for p in ps:
            part = Af[p] @ Bf[t - p]
            acc = part if acc is None else acc + part
        w = 2.0 ** (-INT8_BETA * (t + 2))
        out = acc * w if out is None else out + acc * w
    return out * (a_scale * b_scale)


def _check(A: torch.Tensor, B: torch.Tensor) -> None:
    if A.dtype != torch.float64 or B.dtype != torch.float64:
        raise TypeError("matmul_f64_mxu expects f64 operands")
    if A.shape[-1] > K_MAX:
        raise ValueError("contraction too long for int32 accumulation")
    if A.ndim < 2 or B.ndim != A.ndim or A.shape[:-2] != B.shape[:-2] \
            or A.shape[-1] != B.shape[-2]:
        raise ValueError(f"expected [..., n, k] @ [..., k, c], got {tuple(A.shape)} @ "
                         f"{tuple(B.shape)}")


def matmul_f64_int8_plain(A: torch.Tensor, B: torch.Tensor, bits: int = 55) -> torch.Tensor:
    """A [..., n, k] @ B [..., k, c] by the integer Ozaki scheme in plain
    torch: the JAX function step by step."""
    _check(A, B)
    s = _num_slices(bits)
    Asl, a_scale = _slice_int8(A, -1, s)
    Bsl, b_scale = _slice_int8(B, -2, s)
    return _ozaki_sum(Asl, Bsl, a_scale, b_scale, bits)


# --------------------------------------------------------------------------
# the kernels (csrc/int8gemm.cu)
# --------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("int8gemm")
    if not getattr(lib, "_lt_bound", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lt_ozaki_slice_s8.argtypes = [vp] * 3 + [i] * 5 + [ll] * 3 + [vp]
        lib.lt_ozaki_gemm_s8.argtypes = [vp] * 5 + [i] * 6 + [vp]
        for fn in (lib.lt_ozaki_slice_s8, lib.lt_ozaki_gemm_s8):
            fn.restype = ctypes.c_int
        lib._lt_bound = True
    return lib


def _raise_on(fn, rc: int, shapes) -> None:
    if rc == -2:
        raise RuntimeError(f"{fn.__name__}: shapes {shapes} are outside what the kernel takes")
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {rc}")


def ozaki_slice_s8_cuda(X: torch.Tensor, e: torch.Tensor, s: int) -> torch.Tensor:
    """O1: X f64 [batch, rows, k] (any strides), e int32 [batch, rows] ->
    int8 [s, batch, rows, kp], the slices of each fiber X[b, r, :] on its
    grid 2^e, k-contiguous and zero-padded to kp = round_up(k, 16). B's
    columns are sliced by passing B.mT (a view)."""
    if X.device.type != "cuda" or e.device != X.device:
        raise ValueError(f"expected CUDA tensors on one device, got {X.device}, {e.device}")
    if X.dtype != torch.float64 or X.ndim != 3:
        raise ValueError(f"expected f64 [batch, rows, k], got {tuple(X.shape)} {X.dtype}")
    batch, rows, k = X.shape
    if e.dtype != torch.int32 or tuple(e.shape) != (batch, rows):
        raise ValueError(f"expected int32 exponents [{batch}, {rows}], got {tuple(e.shape)} "
                         f"{e.dtype}")
    e = e.contiguous()
    kp = (k + 15) // 16 * 16
    out = torch.empty((s, batch, rows, kp), dtype=torch.int8, device=X.device)
    fn = _lib().lt_ozaki_slice_s8
    with torch.cuda.device(X.device):
        rc = fn(X.data_ptr(), e.data_ptr(), out.data_ptr(), s, batch, rows, k, kp,
                *X.stride(), torch.cuda.current_stream().cuda_stream)
    _raise_on(fn, rc, (tuple(X.shape), s))
    ozaki_slice_s8_cuda.launches += 1
    return out


def ozaki_gemm_s8_cuda(Asl: torch.Tensor, Bsl: torch.Tensor, a_scale: torch.Tensor,
                       b_scale: torch.Tensor, tmax: int) -> torch.Tensor:
    """O2: A's slices int8 [s, batch, n, kp] and B's transposed slices
    [s, batch, c, kp], scales f64 [batch, n] and [batch, c] ->
    f64 [batch, n, c] = a_scale b_scale sum_t 2^(-6(t+2)) sum_{p+q=t}
    Q_p(A) Q_q(B)^T, for t = 0..tmax."""
    tensors = (Asl, Bsl, a_scale, b_scale)
    if any(x.device.type != "cuda" or x.device != Asl.device for x in tensors):
        raise ValueError("expected CUDA tensors on one device")
    if Asl.dtype != torch.int8 or Bsl.dtype != torch.int8 or Asl.ndim != 4 or Bsl.ndim != 4:
        raise ValueError(f"expected int8 [s, batch, rows, kp] slices, got {tuple(Asl.shape)} "
                         f"{Asl.dtype}, {tuple(Bsl.shape)} {Bsl.dtype}")
    s, batch, n, kp = Asl.shape
    c = Bsl.shape[2]
    if Bsl.shape[:2] != (s, batch) or Bsl.shape[3] != kp or kp % 16:
        raise ValueError(f"slices {tuple(Asl.shape)} and {tuple(Bsl.shape)} do not match")
    if any(x.dtype != torch.float64 for x in (a_scale, b_scale)) \
            or tuple(a_scale.shape) != (batch, n) or tuple(b_scale.shape) != (batch, c):
        raise ValueError(f"expected f64 scales [{batch}, {n}] and [{batch}, {c}]")
    if not (Asl.is_contiguous() and Bsl.is_contiguous()):
        raise ValueError("slices must be contiguous")
    a_scale, b_scale = a_scale.contiguous(), b_scale.contiguous()
    out = torch.empty((batch, n, c), dtype=torch.float64, device=Asl.device)
    fn = _lib().lt_ozaki_gemm_s8
    with torch.cuda.device(Asl.device):
        rc = fn(Asl.data_ptr(), Bsl.data_ptr(), a_scale.data_ptr(), b_scale.data_ptr(),
                out.data_ptr(), s, tmax, batch, n, c, kp,
                torch.cuda.current_stream().cuda_stream)
    _raise_on(fn, rc, (tuple(Asl.shape), tuple(Bsl.shape), tmax))
    ozaki_gemm_s8_cuda.launches += 1
    return out


ozaki_slice_s8_cuda.launches = 0
ozaki_gemm_s8_cuda.launches = 0


def matmul_f64_int8_cuda(A: torch.Tensor, B: torch.Tensor, bits: int = 55) -> torch.Tensor:
    """The integer Ozaki product on the card: O1 on A's rows and B's
    columns, then O2. Same contract and result as `matmul_f64_int8_plain`."""
    _check(A, B)
    if B.device != A.device:
        raise ValueError(f"operands on {A.device} and {B.device}")
    *lead, n, k = A.shape
    c = B.shape[-1]
    if 0 in (n, k, c, *lead):
        return torch.zeros((*lead, n, c), dtype=torch.float64, device=A.device)
    A3, B3 = A.reshape(-1, n, k), B.reshape(-1, k, c)
    s = _num_slices(bits)
    ea, a_scale = fiber_exponents(A3, -1)  # [batch, n, 1]
    eb, b_scale = fiber_exponents(B3, -2)  # [batch, 1, c]
    Asl = ozaki_slice_s8_cuda(A3, ea[..., 0], s)
    Bsl = ozaki_slice_s8_cuda(B3.mT, eb[:, 0], s)
    out = ozaki_gemm_s8_cuda(Asl, Bsl, a_scale[..., 0], b_scale[:, 0],
                             pair_schedule(s, bits)[-1][0])
    return out.reshape(*lead, n, c)


def matmul_f64_mxu(A: torch.Tensor, B: torch.Tensor, bits: int = 55) -> torch.Tensor:
    """A [..., n, k] @ B [..., k, c] in f64-equivalent accuracy from int8
    products (the leading axes are a batch, equal in both): the kernels for
    CUDA tensors, the plain version for CPU ones."""
    if A.device.type == "cpu" and B.device.type == "cpu":
        return matmul_f64_int8_plain(A, B, bits)
    if A.device.type == "cuda":
        return matmul_f64_int8_cuda(A, B, bits)
    raise ValueError(f"no int8 GEMM route for device {A.device}")

