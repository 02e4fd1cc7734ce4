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
stays below 2^28) for CPU tensors, and for CUDA tensors the hand-written
kernels of `csrc/int8gemm.cu` (built with nvcc for sm_90a at first use),
with no fallback:

  O1 `ozaki_slice_s8_cuda` <- `int8gemm.py::_slice_int8`: one launch an
     operand computes the fiber exponents, the scales and the slices
     (plain version `slice_plain`)
  O2 `ozaki_gemm_s8_cuda`  <- `int8gemm.py::matmul_f64_mxu`'s pair loop:
     wgmma on TMA-fed int8 tiles, one int32 accumulator per weight t, the
     tiles' weights split into chunks by `gemm_plan` (plain version
     `_ozaki_sum`)

Neither is a Pallas kernel in the JAX package (XLA ops there). A whole
product is at most four launches (O1 twice, O2 and its epilogue), and the
kernels equal the plain version bit for bit. On this card the int8 tensor
cores' 1,979 TOPS do not make up for the 76 products (s = 11): the route
loses to the library's f64 GEMM, and stays opt-in
(``gemm_backend='int8'``), as in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
from typing import List, NamedTuple, Tuple

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
    "slice_plain",
    "gemm_plan",
    "plan_for",
    "GemmPlan",
    "INT8_BETA",
    "K_MAX",
    "Q_MAX",
]

INT8_BETA = 6  # payload bits per slice: |q| <= 33 fits int8 with headroom
_TINY = 2.0**-1000
K_MAX = 1 << 17  # longest contraction whose partials stay exact in int32
Q_MAX = 33  # |q| of a slice (in fact <= 32: 2^e >= 2 max|x|)
# O2 keeps one int32 accumulator per weight t over all of its (at most 11)
# pairs: exact for every contraction `_check` admits
assert 11 * Q_MAX**2 * K_MAX < 2**31


def _num_slices(bits: int) -> int:
    return int(math.ceil(bits / INT8_BETA)) + 1


def _pairs(s: int, tmax: int) -> List[Tuple[int, List[int]]]:
    return [(t, list(range(max(0, t - s + 1), min(s, t + 1)))) for t in range(tmax + 1)]


def pair_schedule(s: int, bits: int) -> List[Tuple[int, List[int]]]:
    """[(t, [p, ...]), ...]: the slice pairs (p, t - p) of each weight t,
    in the order both versions sum them (`int8gemm.py:82-99`)."""
    return _pairs(s, min(2 * s - 2, _num_slices(bits)))


def fiber_exponents(X: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(e int32, 2^e f64), keepdim along ``dim``: 2^e in [2 mx, 4 mx] for the
    fiber max mx (clamped to 2^-1000), as `int8gemm.py:51-53`."""
    mx = X.abs().amax(dim=dim, keepdim=True)
    e = ceil_log2(torch.clamp_min(mx, _TINY))
    return e, pow2_int(e)


def _slices(X: torch.Tensor, e: torch.Tensor, s: int) -> torch.Tensor:
    """int8 [s, ...]: X's slices on the grid 2^e (e broadcastable to X).
    Every step is exact: q is an integer of at most 7 bits and the factors
    are powers of two."""
    R = X
    out = []
    for p in range(s):
        inv = pow2_int(INT8_BETA * (p + 1) - e)
        sigma = pow2_int(e - INT8_BETA * (p + 1))
        q = torch.round(R * inv)
        out.append(q.to(torch.int8))
        R = R - q * sigma
    return torch.stack(out)


def _slice_int8(X: torch.Tensor, axis: int, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slices int8 [s, ...], scale f64 broadcastable to X),
    X = sum_p scale 2^(-6(p+1)) slices[p] + residual."""
    e, scale = fiber_exponents(X, axis)
    return _slices(X, e, s), scale


def slice_plain(X: torch.Tensor, s: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O1's plain version in O1's layout: X f64 [batch, rows, k] ->
    (slices int8 [s, batch, rows, kp], zero-padded to kp = round_up(k, 16);
    e int32 [batch, rows]; 2^e f64 [batch, rows]), each fiber X[b, r, :] on
    its own grid."""
    e, scale = fiber_exponents(X, -1)
    k = X.shape[-1]
    sl = torch.nn.functional.pad(_slices(X, e, s), (0, (-k) % 16))
    return sl, e[..., 0], scale[..., 0]


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
# O2's work split (pure Python; csrc/int8gemm.cu runs what it returns)
# --------------------------------------------------------------------------

TILE = 128  # O2's output tile, rows and columns
CLUSTER = 2  # O2's cluster of row tiles sharing B's tile (csrc/int8gemm.cu CM)
_MAX_CHUNKS = 8
# The planner's cost model, in microseconds (an estimate to rank splits by,
# fitted to O2's times on an NVIDIA H100 80GB HBM3 at 700 W): a cluster's
# pair runs 4 ceil(kp/128) k32 steps of a 128 x 128 tile at 0.43 of the
# int8 peak of an SM (1,979 TOPS / 132) with the card full, and faster
# when fewer SMs share the L2 (x the first wave's occupancy, at least
# 0.75); a unit pays a pipeline fill and drain and its last writes, and
# each of its weights t an f64 update or a workspace store; the epilogue
# moves the workspace once each way, mostly within L2, and costs a launch.
_SM_RATE = 0.43 * 1979e12 / 132
_MIN_SHARE = 0.75
_UNIT_US = 10.0
_T_US = 0.5
_WS_BYTES_PER_US = 10e6
_EPI_US = 3.0


class GemmPlan(NamedTuple):
    """O2's units. The tile grid, tn x tc tiles of 128 x 128 a batch element,
    tn padded to whole clusters of `CLUSTER` row tiles (a tile past n
    computes zeros and writes nothing); each tile's weights t = 0..tmax cut
    into the chunks [tlo[i], tlo[i+1]); the kernel's block u runs chunk
    ``order[u // tiles]`` (longest chunks first) on the tile `units` gives
    it. Chunk 0 carries the f64 sum; the later chunks' int32 sums go through
    the workspace to the epilogue."""

    batch: int
    tn: int
    tc: int
    tlo: Tuple[int, ...]
    order: Tuple[int, ...]

    @property
    def tiles(self) -> int:
        return self.batch * self.tn * self.tc

    def units(self) -> List[Tuple[int, int, int, int]]:
        """[(chunk, b, ti, tj), ...] in launch order, as the kernel maps its
        blocks: the CTA of rank u % CLUSTER in cluster g = (u % tiles) //
        CLUSTER has the tile (CLUSTER tp + rank, tj) of batch element b."""
        tnp = self.tn // CLUSTER
        out = []
        for u in range(self.tiles * len(self.order)):
            g = (u % self.tiles) // CLUSTER
            out.append((self.order[u // self.tiles], g // (tnp * self.tc),
                        (g % (tnp * self.tc)) // self.tc * CLUSTER + u % CLUSTER,
                        g % self.tc))
        return out


def _partition(w: List[int], C: int) -> List[int]:
    """Boundaries 0 = b0 < ... < bC = len(w) of the contiguous split of w
    into C groups with the smallest largest sum."""
    n = len(w)
    pre = [0]
    for x in w:
        pre.append(pre[-1] + x)
    INF = float("inf")
    best = [[INF] * (C + 1) for _ in range(n + 1)]
    cut = [[0] * (C + 1) for _ in range(n + 1)]
    best[0][0] = 0
    for i in range(1, n + 1):
        for g in range(1, min(C, i) + 1):
            for j in range(g - 1, i):
                v = max(best[j][g - 1], pre[i] - pre[j])
                if v < best[i][g]:
                    best[i][g], cut[i][g] = v, j
    bounds, i = [n], n
    for g in range(C, 0, -1):
        i = cut[i][g]
        bounds.append(i)
    return bounds[::-1]


def plan_for(batch: int, n: int, c: int, s: int, tlo) -> GemmPlan:
    """The plan that runs the chunks ``tlo`` (0 = tlo[0] < ... = tmax + 1),
    longest (most slice pairs) first."""
    tn = -(-(-(-n // TILE)) // CLUSTER) * CLUSTER
    pairs = [len(ps) for _, ps in _pairs(s, tlo[-1] - 1)]
    w = [sum(pairs[tlo[i]:tlo[i + 1]]) for i in range(len(tlo) - 1)]
    order = sorted(range(len(w)), key=lambda i: (-w[i], i))
    return GemmPlan(batch, tn, -(-c // TILE), tuple(tlo), tuple(order))


@functools.lru_cache(maxsize=64)
def gemm_plan(batch: int, n: int, c: int, kp: int, s: int, tmax: int, sms: int) -> GemmPlan:
    """O2's split for [batch, n, kp] @ [batch, kp, c] at weights 0..tmax on
    ``sms`` SMs: the number of chunks, each cut to balance pair counts, whose
    clusters, scheduled longest first as clusters of SMs free up (blocks
    start in launch order), finish first under the cost model above, the
    epilogue included. 800^2 has 56 tiles for 132 SMs and splits in two;
    2401^2 fills the card three times over and does not split."""
    pairs = [len(ps) for _, ps in _pairs(s, tmax)]
    pair_us = 2.0 * TILE * TILE * 128 * -(-kp // 128) / _SM_RATE * 1e6
    best = None
    for C in range(1, min(tmax + 1, _MAX_CHUNKS) + 1):
        plan = plan_for(batch, n, c, s, _partition(pairs, C))
        tlo, clusters, slots = plan.tlo, plan.tiles // CLUSTER, max(1, sms // CLUSTER)
        share = max(_MIN_SHARE, min(1.0, clusters * C / slots))
        cost = [sum(pairs[tlo[i]:tlo[i + 1]]) * pair_us * share + _UNIT_US
                + (tlo[i + 1] - tlo[i]) * _T_US for i in range(C)]
        free = [0.0] * min(slots, clusters * C)
        for ch in plan.order:
            for _ in range(clusters):
                heapq.heapreplace(free, free[0] + cost[ch])
        total = max(free)
        if C > 1:
            ntl = tmax + 1 - tlo[1]
            total += _EPI_US + 2 * plan.tiles * TILE * TILE * (8 + 4 * ntl) / _WS_BYTES_PER_US
        if best is None or total < best[0]:
            best = (total, plan)
    return best[1]


# --------------------------------------------------------------------------
# the kernels (csrc/int8gemm.cu)
# --------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("int8gemm")
    if not getattr(lib, "_lt_bound", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lt_ozaki_slice_s8.argtypes = [vp] * 4 + [i] * 5 + [ll] * 3 + [vp]
        lib.lt_ozaki_gemm_s8.argtypes = [vp] * 7 + [i] * 7 + [vp] * 3
        for fn in (lib.lt_ozaki_slice_s8, lib.lt_ozaki_gemm_s8):
            fn.restype = ctypes.c_int
        lib.lt_ozaki_gemm_tiles.argtypes = [i] * 3
        lib.lt_ozaki_gemm_tiles.restype = ll
        lib._lt_bound = True
    return lib


def _raise_on(fn, rc: int, shapes) -> None:
    if rc == -2:
        raise RuntimeError(f"{fn.__name__}: shapes {shapes} are outside what the kernel takes")
    if rc == -3:
        raise RuntimeError(f"{fn.__name__}: no TMA tensor map for {shapes}")
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {rc}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ozaki_slice_s8_cuda(X: torch.Tensor, s: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O1: X f64 [batch, rows, k] (any strides) -> (int8 [s, batch, rows, kp],
    the slices of each fiber X[b, r, :] on its grid 2^e, k-contiguous and
    zero-padded to kp = round_up(k, 16); e int32 [batch, rows]; 2^e f64
    [batch, rows]), as `slice_plain`. B's columns are sliced by passing
    B.mT (a view)."""
    if X.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {X.device}")
    if X.dtype != torch.float64 or X.ndim != 3:
        raise ValueError(f"expected f64 [batch, rows, k], got {tuple(X.shape)} {X.dtype}")
    batch, rows, k = X.shape
    kp = (k + 15) // 16 * 16
    out = torch.empty((s, batch, rows, kp), dtype=torch.int8, device=X.device)
    e = torch.empty((batch, rows), dtype=torch.int32, device=X.device)
    scale = torch.empty((batch, rows), dtype=torch.float64, device=X.device)
    fn = _lib().lt_ozaki_slice_s8
    with torch.cuda.device(X.device):
        rc = fn(X.data_ptr(), out.data_ptr(), e.data_ptr(), scale.data_ptr(), s, batch, rows,
                k, kp, *X.stride(), torch.cuda.current_stream().cuda_stream)
    _raise_on(fn, rc, (tuple(X.shape), s))
    ozaki_slice_s8_cuda.launches += 1
    return out, e, scale


def ozaki_gemm_s8_cuda(Asl: torch.Tensor, Bsl: torch.Tensor, a_scale: torch.Tensor,
                       b_scale: torch.Tensor, tmax: int, plan: GemmPlan = None
                       ) -> torch.Tensor:
    """O2: A's slices int8 [s, batch, n, kp] and B's transposed slices
    [s, batch, c, kp], scales f64 [batch, n] and [batch, c] ->
    f64 [batch, n, c] = a_scale b_scale sum_t 2^(-6(t+2)) sum_{p+q=t}
    Q_p(A) Q_q(B)^T, for t = 0..tmax, split as ``plan`` says (by default
    `gemm_plan` for this card). The kernel and, with more than one chunk,
    its epilogue: one launch counted."""
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
    if s * Q_MAX**2 * kp >= 2**31:
        raise ValueError(f"{s} slices of depth {kp} overflow the int32 accumulator")
    if any(x.dtype != torch.float64 for x in (a_scale, b_scale)) \
            or tuple(a_scale.shape) != (batch, n) or tuple(b_scale.shape) != (batch, c):
        raise ValueError(f"expected f64 scales [{batch}, {n}] and [{batch}, {c}]")
    if not (Asl.is_contiguous() and Bsl.is_contiguous()):
        raise ValueError("slices must be contiguous")
    a_scale, b_scale = a_scale.contiguous(), b_scale.contiguous()
    if plan is None:
        plan = gemm_plan(batch, n, c, kp, s, tmax, _sm_count(Asl.device.index))
    lib = _lib()
    if plan.tlo[-1] != tmax + 1 or plan.tiles != lib.lt_ozaki_gemm_tiles(batch, n, c) \
            or plan.batch != batch:
        raise ValueError(f"plan {plan} does not fit weights 0..{tmax} and shapes "
                         f"{tuple(Asl.shape)}, {tuple(Bsl.shape)}")
    out = torch.empty((batch, n, c), dtype=torch.float64, device=Asl.device)
    ws64 = ws32 = None
    if len(plan.order) > 1:  # the later chunks' int32 sums, chunk 0's f64 sums
        ws64 = torch.empty((plan.tiles, TILE * TILE), dtype=torch.float64, device=Asl.device)
        ws32 = torch.empty((plan.tiles, tmax + 1 - plan.tlo[1], TILE * TILE),
                           dtype=torch.int32, device=Asl.device)
    nch = len(plan.order)
    tlo = (ctypes.c_int * (nch + 1))(*plan.tlo)
    order = (ctypes.c_int * nch)(*plan.order)
    fn = lib.lt_ozaki_gemm_s8
    with torch.cuda.device(Asl.device):
        rc = fn(Asl.data_ptr(), Bsl.data_ptr(), a_scale.data_ptr(), b_scale.data_ptr(),
                out.data_ptr(), None if ws64 is None else ws64.data_ptr(),
                None if ws32 is None else ws32.data_ptr(), s, tmax, batch, n, c, kp, nch,
                tlo, order, torch.cuda.current_stream().cuda_stream)
    _raise_on(fn, rc, (tuple(Asl.shape), tuple(Bsl.shape), tmax, plan))
    ozaki_gemm_s8_cuda.launches += 1
    return out


ozaki_slice_s8_cuda.launches = 0
ozaki_gemm_s8_cuda.launches = 0


def matmul_f64_int8_cuda(A: torch.Tensor, B: torch.Tensor, bits: int = 55) -> torch.Tensor:
    """The integer Ozaki product on the card: O1 on A's rows and on B's
    columns, then O2 (at most four launches). Same contract and result as
    `matmul_f64_int8_plain`."""
    _check(A, B)
    if B.device != A.device:
        raise ValueError(f"operands on {A.device} and {B.device}")
    *lead, n, k = A.shape
    c = B.shape[-1]
    if 0 in (n, k, c, *lead):
        return torch.zeros((*lead, n, c), dtype=torch.float64, device=A.device)
    A3, B3 = A.reshape(-1, n, k), B.reshape(-1, k, c)
    s = _num_slices(bits)
    Asl, _, a_scale = ozaki_slice_s8_cuda(A3, s)
    Bsl, _, b_scale = ozaki_slice_s8_cuda(B3.mT, s)
    out = ozaki_gemm_s8_cuda(Asl, Bsl, a_scale, b_scale, pair_schedule(s, bits)[-1][0])
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
