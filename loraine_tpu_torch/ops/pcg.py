"""Single-launch CG for the materialized small-n CG path: B3 and B4. Port
of `loraine_tpu/ops/pcg_pallas.py` (`pcg_pallas_ff`, `pcg_pallas_mixed`).

The two Pallas TPU kernels become hand-written CUDA kernels
(`csrc/pcg.cu`, built with nvcc for sm_90a at first use):

  B3 `cg_minres_f64_cuda` <- `pcg_pallas.py::_kernel_ff`
  B4 `cg_f32_cuda`        <- `pcg_pallas.py::_kernel`

Each runs one whole CG solve on the split-preconditioned system
Hp = Mli H Mli^T in one launch. B3's body is native f64 where the TPU kernel
computes in float-float (2 x f32, ~2^-47): the TPU has no f64 unit, the H100
has. Everything else is the TPU kernel's: the minimum-residual iterate
(strict < improvement), the stall exit after ``np // 2 + 64`` non-improving
iterations with np = `pow2_pad(n)` as in the JAX package, and the pAp / rr
breakdown guards. B4 is the plain f32 CG of `_kernel`.

Beside each kernel is its plain PyTorch version (`cg_minres_plain`,
`cg_f32_plain`), the same loop as tensor ops. The dispatchers
`cg_minres_f64` / `cg_f32` take the plain version only for a tensor on the
CPU; for a CUDA tensor they launch the kernel or raise, with no fallback.

The wrappers `pcg_kernel_ff` / `pcg_kernel_mixed` keep the JAX wrappers'
f64 logic: per-pass preconditioned rhs, the inner tolerance
max(0.25 target / ||rp||, floor) (2.0 once a pass has converged), the caps
min(maxiter, 4n + 128) and min(maxiter, 2n + 64), and (ff) the rejection of
a pass that worsens the f64 residual. All of it stays on the device: the
kernels read tol^2 from device memory and leave the iteration count there.
"""
from __future__ import annotations

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
    "cg_minres_plain",
    "cg_f32_plain",
    "cg_minres_f64_cuda",
    "cg_f32_cuda",
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


# --------------------------------------------------------------------------
# CUDA kernels (csrc/pcg.cu)
# --------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("pcg")
    if not getattr(lib, "_lt_bound", False):
        ptrs = [ctypes.c_void_p] * 6
        lib.lt_cg_minres_f64.argtypes = ptrs + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.lt_cg_f32.argtypes = ptrs + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.lt_cg_scratch_len.argtypes = [ctypes.c_int]
        for fn in (lib.lt_cg_minres_f64, lib.lt_cg_f32, lib.lt_cg_scratch_len):
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


def _launch(fn, Hp, b, tol2, maxiter: int, *extra) -> Tuple[torch.Tensor, torch.Tensor]:
    n = b.shape[0]
    Hp, b, tol2 = Hp.contiguous(), b.contiguous(), tol2.contiguous()
    x = torch.empty_like(b)
    it = torch.empty((), dtype=torch.int32, device=b.device)
    lib = _lib()
    scratch = torch.empty(lib.lt_cg_scratch_len(n), dtype=b.dtype, device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(Hp.data_ptr(), b.data_ptr(), tol2.data_ptr(), x.data_ptr(), it.data_ptr(),
                scratch.data_ptr(), n, int(maxiter), *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {rc}")
    return x, it


def cg_minres_f64_cuda(
    Hp: torch.Tensor, b: torch.Tensor, tol2: torch.Tensor, maxiter: int, stall_max: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3 on the card: same contract as `cg_minres_plain`."""
    _check(Hp, b, tol2, torch.float64)
    out = _launch(_lib().lt_cg_minres_f64, Hp, b, tol2, maxiter, int(stall_max))
    cg_minres_f64_cuda.launches += 1
    return out


def cg_f32_cuda(
    Hp: torch.Tensor, b: torch.Tensor, tol2: torch.Tensor, maxiter: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4 on the card: same contract as `cg_f32_plain`."""
    _check(Hp, b, tol2, torch.float32)
    out = _launch(_lib().lt_cg_f32, Hp, b, tol2, maxiter)
    cg_f32_cuda.launches += 1
    return out


cg_minres_f64_cuda.launches = 0
cg_f32_cuda.launches = 0


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
