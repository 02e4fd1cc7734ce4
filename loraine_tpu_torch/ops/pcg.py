"""Single-launch CG for the materialized small-n CG path: B3, B4 and the
f64 polish. Port of `loraine_tpu/ops/pcg_pallas.py` (`pcg_pallas_ff`,
`pcg_pallas_mixed`) and of the polish of `loraine_tpu/ipm/step.py:820-835`.

The two Pallas TPU kernels become hand-written CUDA kernels
(`csrc/pcg.cu`, built with nvcc for sm_90a at first use), and the polish
runs through the same kernel:

  B3     `cg_minres_f64_cuda` <- `pcg_pallas.py::_kernel_ff`
  B4     `cg_f32_cuda`        <- `pcg_pallas.py::_kernel`
  polish `cg_f64_cuda`        <- the f64 last-iterate CG after B3

Each runs one whole CG solve on the split-preconditioned system
Hp = Mli H Mli^T in one launch. B3's body is native f64 where the TPU kernel
computes in float-float (2 x f32, ~2^-47): the TPU has no f64 unit, the H100
has. Everything else is the TPU kernel's: the minimum-residual iterate
(strict < improvement), the stall exit after ``np // 2 + 64`` non-improving
iterations with np = `pow2_pad(n)` as in the JAX package, and the pAp / rr
breakdown guards. B4 is the plain f32 CG of `_kernel`, the polish the same
loop in f64.

The kernel has three regimes, chosen by the shape alone (`regime_for_cg`):
"block" (one block, Hp in its shared memory), "cluster" (one thread block
cluster, Hp's rows spread over the blocks' shared memory) and, past a
cluster's capacity, "grid" (a cooperative launch, Hp read from L2 every
iteration). Each is one launch per solve.

Beside each kernel is its plain PyTorch version (`cg_minres_plain`,
`cg_f32_plain`, `cg_f64_plain`), the same loop as tensor ops. The
dispatchers `cg_minres_f64` / `cg_f32` / `cg_f64` take the plain version
only for a tensor on the CPU; for a CUDA tensor they launch the kernel or
raise, with no fallback.

The wrappers `pcg_kernel_ff` / `pcg_kernel_mixed` keep the JAX wrappers'
f64 logic: per-pass preconditioned rhs, the inner tolerance
max(0.25 target / ||rp||, floor) (2.0 once a pass has converged), the caps
min(maxiter, 4n + 128) and min(maxiter, 2n + 64), and (ff) the rejection of
a pass that worsens the f64 residual. All of it stays on the device: the
kernels read tol^2 from device memory and leave the iteration count there.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Callable, Optional, Tuple, Union

import torch

from .linalg import sym

__all__ = [
    "pow2_pad",
    "stall_limit",
    "pcg_kernel_ff",
    "pcg_kernel_mixed",
    "cg_minres_f64",
    "cg_f32",
    "cg_f64",
    "cg_minres_plain",
    "cg_f32_plain",
    "cg_f64_plain",
    "cg_minres_f64_cuda",
    "cg_f32_cuda",
    "cg_f64_cuda",
    "regime_for_cg",
    "cg_smem_bytes",
    "CLUSTER_BLOCKS",
    "CLUSTER_FROM",
]

_LANES = 128
_FF_TOL_FLOOR = 1.0e-12  # pcg_pallas.py:537
_F32_TOL_FLOOR = 5.0e-7  # pcg_pallas.py:189

Scalar = Union[float, torch.Tensor]


def pow2_pad(n: int) -> int:
    """Smallest power-of-two multiple of 128 holding n
    (`pcg_pallas.py:_pow2_pad`): the TPU kernel's padded size, kept so that
    the stall exit fires at the same iteration."""
    p = _LANES
    while p < n:
        p *= 2
    return p


def stall_limit(n: int) -> int:
    """Non-improving iterations before B3 gives up (`pcg_pallas.py:400`)."""
    return pow2_pad(n) // 2 + 64


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------


def _nonzero(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v != 0, v, torch.ones_like(v))


def _cg_loop(Hp, b, tol2, maxiter: int, stall_max: Optional[int]):
    """CG on Hp x = b from x = 0 with the kernels' guards and stopping rule
    (rr <= tol2 or maxiter). With ``stall_max`` it returns the iterate of
    least ||r||^2 (strict < improvement) and also stops after ``stall_max``
    non-improving iterations; without, the last iterate."""
    x, r, p = torch.zeros_like(b), b, b
    rr = torch.dot(b, b)
    best_x, best_rr = x, rr
    it = stall = 0
    while it < maxiter and (stall_max is None or stall < stall_max) and bool(rr > tol2):
        Ap = Hp @ p
        alpha = rr / _nonzero(torch.dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = torch.dot(r, r)
        p = r + (rr_new / _nonzero(rr)) * p
        if stall_max is not None:
            if bool(rr_new < best_rr):
                best_x, best_rr, stall = x, rr_new, 0
            else:
                stall += 1
        rr = rr_new
        it += 1
    out = x if stall_max is None else best_x
    return out, torch.tensor(it, dtype=torch.int32, device=b.device)


def cg_minres_plain(
    Hp: torch.Tensor, b: torch.Tensor, tol2: torch.Tensor, maxiter: int, stall_max: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B3 (`pcg_pallas.py:376-437` in f64). Returns the
    iterate of least ||r||^2 and the iteration count (int32 tensor)."""
    return _cg_loop(Hp, b, tol2, maxiter, stall_max)


def cg_f32_plain(
    Hp: torch.Tensor, b: torch.Tensor, tol2: torch.Tensor, maxiter: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B4 (`pcg_pallas.py:48-99`): f32 CG, last iterate."""
    return _cg_loop(Hp, b, tol2, maxiter, None)


def cg_f64_plain(
    Hp: torch.Tensor, b: torch.Tensor, tol2: torch.Tensor, maxiter: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the polish kernel: f64 CG, last iterate."""
    return _cg_loop(Hp, b, tol2, maxiter, None)


# --------------------------------------------------------------------------
# CUDA kernels (csrc/pcg.cu)
# --------------------------------------------------------------------------


# The kernel's regimes, chosen by the shape alone (csrc/pcg.cu's note):
# "block", one block with Hp in its shared memory; "cluster", one cluster of
# CLUSTER_BLOCKS blocks, each holding its share of Hp's rows;
# "grid", a cooperative launch reading Hp from L2, beyond a cluster's
# capacity. The index in CG_REGIMES is the C side's regime code.
CG_REGIMES = ("grid", "block", "cluster")
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use on Hopper
_BLOCK_THREADS = 256  # "block": one thread per row of Hp, so n <= 256
_BLOCK_WARPS = _BLOCK_THREADS // 32
_WARPS = 16  # warps per block in "cluster" (512 threads)
_CMAX = 16  # slots for the blocks' partials in "cluster"
CLUSTER_SIZES = (8, 16)  # the cluster sizes chip_smoke.py times
# the wrappers' cluster size: it holds every n of the regime; on an H100 it
# was within 6% of a cluster of 8 at n <= 256 and 20-25% ahead at n = 464
# and 512 (chip_smoke.py phase 6)
CLUSTER_BLOCKS = 16


def _ceil_div(x: int, k: int) -> int:
    return -(-x // k)


def cg_smem_bytes(regime: str, n: int, dtype: torch.dtype,
                  clusters: int = CLUSTER_BLOCKS) -> int:
    """Dynamic shared memory a block of ``regime`` needs (csrc/pcg.cu's
    block_bytes and cluster_bytes): "block" Hp at an odd row stride, p and
    the warps' partials; "cluster" (of ``clusters`` blocks) two barriers
    (16 bytes), ceil(n / clusters) rows of Hp, the whole p and r, Hp p and
    r on the own rows, the blocks' and the warps' partials; "grid" p."""
    w = torch.empty((), dtype=dtype).element_size()
    if regime == "block":
        return w * (n * (n | 1) + n + 2 * _BLOCK_WARPS)
    if regime == "cluster":
        rows = _ceil_div(n, clusters)
        return 16 + w * (rows * n + 2 * n + 2 * rows + 2 * _CMAX + 2 * _WARPS)
    if regime == "grid":
        return w * n
    raise ValueError(f"unknown regime {regime!r}")


def _fits(regime: str, n: int, dtype: torch.dtype, clusters: int = CLUSTER_BLOCKS) -> bool:
    if regime == "block" and n > _BLOCK_THREADS:
        return False
    return cg_smem_bytes(regime, n, dtype, clusters) <= SMEM_LIMIT


# Where both fit, "cluster" is the faster from this n on: "block" pays each
# thread's walk along its row of Hp (~0.014 us a row in f64), "cluster"
# ~1.2 us more an iteration for its two exchanges. On an H100, "block" led
# at n = 104 and trailed at 128 for B3, B4 and the polish (chip_smoke.py
# phase 6 times both wherever both fit)
CLUSTER_FROM = 128


def regime_for_cg(n: int, dtype: torch.dtype) -> str:
    """The regime of an n x n system in ``dtype``: "block" below
    CLUSTER_FROM (one block holds Hp to f64 n = 169, f32 n = 240), else
    "cluster" where a cluster of 16 blocks holds it (f64 n <= 656, f32
    n <= 944), else "grid"."""
    if n < CLUSTER_FROM and _fits("block", n, dtype):
        return "block"
    if _fits("cluster", n, dtype):
        return "cluster"
    return "grid"


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("pcg")
    if not getattr(lib, "_lt_bound", False):
        ptrs = [ctypes.c_void_p] * 6
        lib.lt_cg_minres_f64.argtypes = ptrs + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.lt_cg_f32.argtypes = ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.lt_cg_f64.argtypes = ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.lt_cg_scratch_len.argtypes = [ctypes.c_int]
        for fn in (lib.lt_cg_minres_f64, lib.lt_cg_f32, lib.lt_cg_f64, lib.lt_cg_scratch_len):
            fn.restype = ctypes.c_int
        lib._lt_bound = True
    return lib


def _check(Hp: torch.Tensor, b: torch.Tensor, tol2: torch.Tensor, dtype: torch.dtype) -> None:
    n = b.shape[0] if b.ndim == 1 else -1
    if Hp.shape != (n, n) or n < 1:
        raise ValueError(f"expected Hp [n, n] and b [n], got {tuple(Hp.shape)} and {tuple(b.shape)}")
    for name, t in (("Hp", Hp), ("b", b), ("tol2", tol2)):
        if t.dtype != dtype or t.device.type != "cuda" or t.device != Hp.device:
            raise ValueError(f"{name}: expected {dtype} on {Hp.device}, got {t.dtype} on {t.device}")
    if tol2.numel() != 1:
        raise ValueError(f"tol2 must be a scalar, got shape {tuple(tol2.shape)}")


# the C functions of the three kernels: (name, takes stall_max)
_FUNCS = {"B3": ("lt_cg_minres_f64", True), "B4": ("lt_cg_f32", False),
          "polish": ("lt_cg_f64", False)}


def _run(kernel: str, Hp, b, tol2, maxiter: int, stall_max: int, regime: str,
         clusters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``kernel`` ("B3", "B4" or "polish") in ``regime`` (with
    ``clusters`` blocks in "cluster"). Scratch comes from torch.empty; the
    kernel allocates nothing. Raises on any launch error."""
    n = b.shape[0]
    Hp, b, tol2 = Hp.contiguous(), b.contiguous(), tol2.contiguous()
    x = torch.empty_like(b)
    it = torch.empty((), dtype=torch.int32, device=b.device)
    lib = _lib()
    name, minres = _FUNCS[kernel]
    fn = getattr(lib, name)
    scratch = None
    if regime == "grid":
        scratch = torch.empty(lib.lt_cg_scratch_len(n), dtype=b.dtype, device=b.device)
    extra = (int(stall_max),) if minres else ()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(Hp.data_ptr(), b.data_ptr(), tol2.data_ptr(), x.data_ptr(), it.data_ptr(),
                None if scratch is None else scratch.data_ptr(), n, int(maxiter), *extra,
                CG_REGIMES.index(regime), int(clusters), stream)
    if rc == -1:
        raise RuntimeError(
            f"{name}: no cluster of {clusters} blocks with "
            f"{cg_smem_bytes(regime, n, b.dtype, clusters)} bytes of shared memory each can be "
            f"resident on this card (cudaOccupancyMaxActiveClusters)")
    if rc == -2:
        raise RuntimeError(f"{name}: n={n} does not fit regime {regime!r} ({clusters} blocks)")
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {rc}")
    return x, it


def _launch(kernel: str, wrapper, Hp, b, tol2, maxiter: int, stall_max: int = 0):
    """One launch in the shape's regime, counted on ``wrapper``."""
    n = b.shape[0]
    regime = regime_for_cg(n, b.dtype)
    out = _run(kernel, Hp, b, tol2, maxiter, stall_max, regime, CLUSTER_BLOCKS)
    wrapper.launches += 1
    wrapper.launches_by_regime[regime] += 1
    return out


def cg_minres_f64_cuda(
    Hp: torch.Tensor, b: torch.Tensor, tol2: torch.Tensor, maxiter: int, stall_max: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3 on the card: same contract as `cg_minres_plain`."""
    _check(Hp, b, tol2, torch.float64)
    return _launch("B3", cg_minres_f64_cuda, Hp, b, tol2, maxiter, stall_max)


def cg_f32_cuda(
    Hp: torch.Tensor, b: torch.Tensor, tol2: torch.Tensor, maxiter: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4 on the card: same contract as `cg_f32_plain`."""
    _check(Hp, b, tol2, torch.float32)
    return _launch("B4", cg_f32_cuda, Hp, b, tol2, maxiter)


def cg_f64_cuda(
    Hp: torch.Tensor, b: torch.Tensor, tol2: torch.Tensor, maxiter: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The polish kernel on the card: same contract as `cg_f64_plain`."""
    _check(Hp, b, tol2, torch.float64)
    return _launch("polish", cg_f64_cuda, Hp, b, tol2, maxiter)


# launch counts, in all and per regime
for _fn in (cg_minres_f64_cuda, cg_f32_cuda, cg_f64_cuda):
    _fn.launches = 0
    _fn.launches_by_regime = collections.Counter()


def _route(b: torch.Tensor, plain, cuda, *args):
    if b.device.type == "cpu":
        return plain(*args)
    if b.device.type == "cuda":
        return cuda(*args)
    raise ValueError(f"no CG kernel route for device {b.device}")


def cg_minres_f64(Hp, b, tol2, maxiter: int, stall_max: int):
    """B3: the kernel for a CUDA tensor, the plain version for a CPU one."""
    return _route(b, cg_minres_plain, cg_minres_f64_cuda, Hp, b, tol2, maxiter, stall_max)


def cg_f32(Hp, b, tol2, maxiter: int):
    """B4: the kernel for a CUDA tensor, the plain version for a CPU one."""
    return _route(b, cg_f32_plain, cg_f32_cuda, Hp, b, tol2, maxiter)


def cg_f64(Hp, b, tol2, maxiter: int):
    """The polish kernel for a CUDA tensor, its plain version for a CPU one."""
    return _route(b, cg_f64_plain, cg_f64_cuda, Hp, b, tol2, maxiter)


# --------------------------------------------------------------------------
# wrappers (pcg_pallas.py: pcg_pallas_ff, pcg_pallas_mixed)
# --------------------------------------------------------------------------


def _target(b: torch.Tensor, tol: Scalar) -> torch.Tensor:
    """Absolute f64 residual target tol * ||b|| (||b|| = 0 counts as 1)."""
    normb = torch.linalg.norm(b)
    return tol * torch.where(normb > 0, normb, torch.ones_like(normb))


def _inner_tol(target, rp, r, floor: float):
    """(normalized rhs, ||rp||, inner tolerance): 0.25 of the pro-rated
    target, at least ``floor``; 2.0 (exit before the first iteration) once
    the f64 residual already meets the target."""
    nr = torch.linalg.norm(rp)
    safe_nr = torch.where(nr > 0, nr, torch.ones_like(nr))
    tol_inner = torch.clamp(0.25 * target / safe_nr, min=floor)
    done = torch.linalg.norm(r) <= target
    tol_inner = torch.where(done, torch.full_like(tol_inner, 2.0), tol_inner)
    return rp / safe_nr, nr, tol_inner


def pcg_kernel_ff(
    H: torch.Tensor,
    Mli: torch.Tensor,
    b: torch.Tensor,
    tol: Scalar,
    maxiter: int,
    passes: int = 2,
    *,
    Hp: Optional[torch.Tensor] = None,
    body: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve H x = b to ||r|| <= tol ||b|| (f64) with B3 inside f64
    iterative refinement (`pcg_pallas_ff`).

    H: [n, n] f64 SPD, Mli: [n, n] f64 inverse Cholesky factor of the
    preconditioner (z = Mli^T Mli r). ``Hp`` may pass sym(Mli H Mli^T) when
    the caller already has it; ``body`` replaces the routed B3 (the card's
    smoke test runs the plain version on CUDA tensors with it). Returns
    (x [n] f64, total inner CG iterations, int32 tensor).
    """
    n = H.shape[-1]
    body = cg_minres_f64 if body is None else body
    MliT = Mli.mT
    if Hp is None:
        Hp = sym(Mli @ H @ MliT)
    Hp = Hp.contiguous()
    target = _target(b, tol)
    # allow the high-kappa iteration counts the f64 loop would also need;
    # the stall exit ends dead passes early
    cap = min(int(maxiter), 4 * n + 128)
    stall = stall_limit(n)
    x, r = torch.zeros_like(b), b
    its = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(passes):
        rhs, nr, tol_inner = _inner_tol(target, Mli @ r, r, _FF_TOL_FLOOR)
        u, it = body(Hp, rhs, tol_inner * tol_inner, cap, stall)
        # refinement must contract: reject an update that worsened the true
        # residual (the min-residual iterate can still back-map badly)
        x_cand = x + MliT @ (u * nr)
        r_cand = b - H @ x_cand
        better = torch.linalg.norm(r_cand) < torch.linalg.norm(r)
        x = torch.where(better, x_cand, x)
        r = torch.where(better, r_cand, r)
        its = its + it
    return x, its


def pcg_kernel_mixed(
    H: torch.Tensor,
    Mli: torch.Tensor,
    b: torch.Tensor,
    tol: Scalar,
    maxiter: int,
    passes: int = 3,
    *,
    Hp: Optional[torch.Tensor] = None,
    body: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve H x = b to ||r|| <= tol ||b|| (f64) with the f32 B4 inside f64
    iterative refinement (`pcg_pallas_mixed`). Same arguments as
    `pcg_kernel_ff`. Sound only at loose tolerances: the f32 body's floor is
    ~u32 * kappa(Hp) per pass."""
    n = H.shape[-1]
    body = cg_f32 if body is None else body
    MliT = Mli.mT
    if Hp is None:
        Hp = sym(Mli @ H @ MliT)
    H32 = Hp.to(torch.float32).contiguous()
    target = _target(b, tol)
    # CG finishes in n steps in exact arithmetic; f32 gets a noise margin
    cap = min(int(maxiter), 2 * n + 64)
    x, r = torch.zeros_like(b), b
    its = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(passes):
        rhs, nr, tol_inner = _inner_tol(target, Mli @ r, r, _F32_TOL_FLOOR)
        tol32 = tol_inner.to(torch.float32)
        u32, it = body(H32, rhs.to(torch.float32), tol32 * tol32, cap)
        x = x + MliT @ (u32.to(b.dtype) * nr)
        r = b - H @ x
        its = its + it
    return x, its
