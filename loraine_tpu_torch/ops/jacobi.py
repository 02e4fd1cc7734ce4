"""Batched f32 parallel cyclic Jacobi: the eigenbasis seed (B1) and the
certified spectral bounds (B2). Port of `loraine_tpu/ops/jacobi_pallas.py`.

The two Pallas TPU kernels become hand-written CUDA kernels
(`csrc/jacobi.cu`, built with nvcc for sm_90a at first use):

  B1 `jacobi_eigh_cuda`   <- `jacobi_pallas.py::_kernel`
  B2 `jacobi_bounds_cuda` <- `jacobi_pallas.py::_kernel_eigmin`

Beside each kernel is its plain PyTorch version (`jacobi_eigh_plain`,
`jacobi_bounds_plain`): the same rounds as batched tensor ops. The
dispatchers `jacobi_eigh_padded` / `jacobi_bounds_padded` take the plain
version only for a tensor on the CPU; for a CUDA tensor they launch the
kernel or raise, with no fallback.

The kernel has three regimes, chosen by the shape alone (`regime_for`):
"sm" (one block per matrix in shared memory), "cluster" (one 16-block
thread block cluster per matrix; B1 adds a cluster for the eigenvector
rows) and, past a cluster's capacity, "rounds" (one launch per round). In
"sm" and "cluster" a call is one launch of the Jacobi kernel. Each regime
rounds every operation once in the plain version's order, so on the card
B1 equals the plain version bit for bit and B2 differs only by the order
of the Gershgorin row sums.

Algorithm (the Pallas kernel's, in index form): round-robin ("tournament")
parallel ordering. The Pallas kernel keeps rows in tournament-position order,
rotates the pairs of positions (i, i + mp/2) and then permutes the rows
physically. Here the matrix stays in its original order and `pair_table`
lists, per round, the original indices that Pallas holds at positions
(i, i + mp/2). After mp-1 rounds P^(mp-1) = I, so one table serves every
sweep, and kernel, plain version and Pallas kernel apply the same rotations
in the same order (to f32 rounding).

The wrappers' pre- and post-processing is the JAX package's: Gershgorin
normalization to spectral radius <= 1, the sentinel pad to
mp = max(round_up(m, 16), 16), the stable ascending sort, and the
32 * eps32 * sqrt(m) * scale widening of the bounds.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = [
    "eigh_jacobi_f32",
    "eig_bounds_jacobi",
    "jacobi_sweeps_for",
    "bound_sweeps_for",
    "pair_table",
    "jacobi_eigh_padded",
    "jacobi_bounds_padded",
    "jacobi_eigh_plain",
    "jacobi_bounds_plain",
    "jacobi_eigh_cuda",
    "jacobi_bounds_cuda",
    "regime_for",
    "smem_bytes",
    "cluster_pairs",
]

_SENTINEL = 2.0  # pad-diagonal value; real spectrum is normalized into [-1, 1]

# Empirical f32 backward-error margin for the certified bounds
# (`jacobi_pallas.py:_EIGMIN_MARGIN_C`).
_EIGMIN_MARGIN_C = 32.0


def _round_up(x: int, k: int) -> int:
    return ((x + k - 1) // k) * k


def jacobi_sweeps_for(m: int) -> int:
    """Sweep count of the eigenbasis seed. Copied verbatim from
    `jacobi_pallas.py:jacobi_sweeps_for`: the schedule sets the IPM
    trajectories the port is held against."""
    base = np.ceil(np.log2(max(m, 4)))
    if m >= 256:
        return int(np.clip(base + 1, 8, 10))
    return int(np.clip(base + 5, 8, 15))


def bound_sweeps_for(m: int) -> int:
    """Sweep count of the bounds. Copied verbatim from
    `jacobi_pallas.py:bound_sweeps_for` (including the constant clip to 4 at
    m >= 256). The Gershgorin bound is valid for any sweep count."""
    base = np.ceil(np.log2(max(m, 4)))
    if m >= 256:
        return int(np.clip(base + 1, 4, 4))
    return int(np.clip(base + 2, 5, 8))


@functools.lru_cache(maxsize=None)
def pair_table(mp: int) -> np.ndarray:
    """[mp-1, 2, mp/2] int32 (read-only): for round r, ``[r, 0, i]`` and
    ``[r, 1, i]`` are the original indices the Pallas kernel holds at
    positions i and i + mp/2. Derived from its row permutation
    `[L0 | R0 L1..L_{h-2}] / [R1..R_{h-1} | L_{h-1}]`
    (`jacobi_pallas.py:127-141`)."""
    if mp < 4 or mp % 2:
        raise ValueError(f"mp must be even and >= 4, got {mp}")
    half = mp // 2
    lab = np.arange(mp)
    rounds = []
    for _ in range(mp - 1):
        rounds.append((lab[:half].copy(), lab[half:].copy()))
        top, bot = lab[:half], lab[half:]
        lab = np.concatenate(
            [top[:1], bot[:1], top[1 : half - 1], bot[1:half], top[half - 1 :]]
        )
    if not np.array_equal(lab, np.arange(mp)):
        raise AssertionError("tournament permutation is not periodic in mp-1")
    table = np.array(rounds, dtype=np.int32)
    table.setflags(write=False)
    return table


_TABLES: Dict[Tuple[int, torch.device, torch.dtype], torch.Tensor] = {}


def _table_on(mp: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    key = (mp, device, dtype)
    t = _TABLES.get(key)
    if t is None:
        t = torch.as_tensor(pair_table(mp).astype(np.int64)).to(device=device, dtype=dtype)
        _TABLES[key] = t
    return t


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------


def _rotation(app, apq, aqq):
    """Givens angle zeroing A[p, q] (stable tan formula,
    `jacobi_pallas.py:151-162`), in f32. Inactive pairs (including every
    pad coupling, which is exactly 0) get the identity rotation."""
    active = apq.abs() > 1e-9 * (app.abs() + aqq.abs() + 1e-3)
    tau = (aqq - app) / (2.0 * torch.where(active, apq, 1.0))
    t = 1.0 / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(active, torch.where(tau >= 0.0, t, -t), 0.0)
    c = 1.0 / torch.sqrt(1.0 + t * t)  # torch.rsqrt is approximate on CUDA
    return c, t * c


def _rotate_halves(M: torch.Tensor, c: torch.Tensor, s: torch.Tensor, dim: int) -> torch.Tensor:
    """[top; bot] -> [c top - s bot; s top + c bot] along ``dim``."""
    top, bot = M.chunk(2, dim)
    return torch.cat([c * top - s * bot, s * top + c * bot], dim)


def _rounds_plain(A: torch.Tensor, VT, sweeps: int):
    """All rounds on A [nb, mp, mp] (and the eigenvector rows VT, if given).
    Each round gathers rows and columns into pair order [p | q], rotates
    rows first, then columns, and scatters back. Returns (A, VT)."""
    mp = A.shape[-1]
    half = mp // 2
    table = _table_on(mp, A.device, torch.long).reshape(mp - 1, mp)
    inverse = torch.argsort(table, dim=1)
    for r in range(sweeps * (mp - 1)):
        pq, back = table[r % (mp - 1)], inverse[r % (mp - 1)]
        A1 = A.index_select(1, pq).index_select(2, pq)
        c, s = _rotation(
            torch.diagonal(A1[:, :half, :half], dim1=1, dim2=2),
            torch.diagonal(A1[:, :half, half:], dim1=1, dim2=2),
            torch.diagonal(A1[:, half:, half:], dim1=1, dim2=2),
        )  # [nb, half]
        B = _rotate_halves(A1, c[:, :, None], s[:, :, None], 1)  # rows: J^T A
        B = _rotate_halves(B, c[:, None, :], s[:, None, :], 2)  # columns: B J
        A = B.index_select(1, back).index_select(2, back)
        if VT is not None:
            VT = _rotate_halves(VT.index_select(1, pq), c[:, :, None], s[:, :, None], 1)
            VT = VT.index_select(1, back)
    return A, VT


def jacobi_eigh_plain(Mp: torch.Tensor, sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B1. Mp: [nb, mp, mp] f32, normalized and padded.
    Returns (lam [nb, mp], VT [nb, mp, mp]) unsorted, rows of VT are the
    eigenvectors."""
    nb, mp, _ = Mp.shape
    VT = torch.eye(mp, dtype=Mp.dtype, device=Mp.device).repeat(nb, 1, 1)
    A, VT = _rounds_plain(Mp, VT, sweeps)
    return torch.diagonal(A, dim1=-2, dim2=-1).clone(), VT


def jacobi_bounds_plain(Mp: torch.Tensor, sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B2: per-row Gershgorin bounds (g, h) [nb, mp] of the
    rotated matrix (`jacobi_pallas.py:241-247`)."""
    A, _ = _rounds_plain(Mp, None, sweeps)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    offsum = A.abs().sum(-1) - diag.abs()
    return diag - offsum, diag + offsum


# --------------------------------------------------------------------------
# CUDA kernels (csrc/jacobi.cu)
# --------------------------------------------------------------------------


# The kernel's regimes, chosen by the shape alone (csrc/jacobi.cu's note):
# "sm", one block per matrix in shared memory; "cluster", one cluster of
# CLUSTER blocks per matrix (B1 adds a second cluster for the eigenvector
# rows); "rounds", one launch per round, beyond a cluster's capacity. The
# index in REGIMES is the C side's regime code.
REGIMES = ("rounds", "sm", "cluster")
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use on Hopper
CLUSTER = 16  # blocks per cluster


def _ceil_div(x: int, k: int) -> int:
    return -(-x // k)


def cluster_pairs(mp: int) -> list:
    """[lo_b, hi_b) of the pair positions block b of a cluster owns (its rows
    are the top positions lo_b..hi_b-1 and the bottom ones mp/2 + lo_b..);
    csrc/jacobi.cu::pair_lo."""
    half = mp // 2
    return [(b * half // CLUSTER, (b + 1) * half // CLUSTER) for b in range(CLUSTER)]


def smem_bytes(regime: str, mp: int, eigvecs: bool) -> int:
    """Dynamic shared memory a block of ``regime`` needs (csrc/jacobi.cu's
    sm_bytes and cluster_bytes): A's rows at stride mp + 1 ("sm") or mp + 4
    ("cluster"), the eigenvector rows at stride mp; per pair a row record
    (16 B) and an angle (8 B), both double buffered, and two label words; in
    a cluster, two slot tables, two sets of 12 edge values and the
    neighbours' slot numbers (16 B). B1's consumer blocks hold mp x
    (ceil(mp/16) rounded up to even) eigenvector entries, the angles and the
    labels."""
    if regime == "sm":
        return 4 * mp * (mp + 1) + 4 * mp * mp * eigvecs + 28 * mp
    if regime == "cluster":
        pairs = _ceil_div(mp // 2, CLUSTER)
        slots = 2 * pairs + 2
        rows = 32 * pairs + 12 * mp + 8 * slots + 112 + 4 * slots * (mp + 4)
        cols = 4 * mp * 2 * _ceil_div(_ceil_div(mp, CLUSTER), 2) + 8 * mp
        return max(rows, cols) if eigvecs else rows
    if regime == "rounds":
        return 0
    raise ValueError(f"unknown regime {regime!r}")


# Where both one-launch regimes fit, the cluster regime is the faster one
# from these padded sizes on (B1, B2; chip_smoke.py phase 2 times both)...
CLUSTER_FROM = {True: 144, False: 192}
# ...while one wave of clusters holds every matrix: an H100 holds at least 6
# clusters of 16 blocks at once (B1, two clusters a matrix, takes as long at
# nb 3 as at nb 1, twice as long at nb 4). Past that the matrices run in
# waves, and "sm", one block a matrix all at once, is the faster.
CLUSTER_WAVE = 6


def regime_for(nb: int, mp: int, eigvecs: bool) -> str:
    """The regime of nb matrices at padded size mp: "sm" below CLUSTER_FROM
    or past one wave of clusters, where its block fits SMEM_LIMIT (B1 to
    mp 160, B2 to 224); else "cluster" where its blocks fit (to mp 912);
    else "rounds"."""
    if smem_bytes("sm", mp, eigvecs) <= SMEM_LIMIT and (
            mp < CLUSTER_FROM[eigvecs] or nb * (1 + eigvecs) > CLUSTER_WAVE):
        return "sm"
    if smem_bytes("cluster", mp, eigvecs) <= SMEM_LIMIT:
        return "cluster"
    return "rounds"


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("jacobi")
    if not getattr(lib, "_lt_bound", False):
        ints = [ctypes.c_int] * 4
        lib.lt_jacobi_eigh_f32.argtypes = [ctypes.c_void_p] * 6 + ints + [ctypes.c_void_p]
        lib.lt_jacobi_bounds_f32.argtypes = [ctypes.c_void_p] * 5 + ints + [ctypes.c_void_p]
        for fn in (lib.lt_jacobi_eigh_f32, lib.lt_jacobi_bounds_f32):
            fn.restype = ctypes.c_int
        lib._lt_bound = True
    return lib


def _check_padded(Mp: torch.Tensor) -> None:
    if Mp.dtype != torch.float32 or Mp.ndim != 3 or Mp.shape[1] != Mp.shape[2]:
        raise ValueError(f"expected [nb, mp, mp] float32, got {tuple(Mp.shape)} {Mp.dtype}")
    if Mp.shape[1] % 16 or Mp.shape[1] < 16:
        raise ValueError(f"mp must be a multiple of 16, got {Mp.shape[1]}")


def _run(eigvecs: bool, Mp: torch.Tensor, outs, sweeps: int, regime: str) -> None:
    """Launch B1 (eigvecs) or B2 on Mp in ``regime``, writing ``outs``
    (B1: VT, lam; B2: g, h). Scratch comes from torch.empty; the kernel
    allocates nothing. Raises on any launch error."""
    nb, mp, _ = Mp.shape
    nrounds = sweeps * (mp - 1)
    A = Mp.contiguous()
    a2 = table = log = None
    if regime == "rounds":  # the round kernel works on two A buffers in turn
        A = A.clone()
        a2 = torch.empty_like(A)
        table = _table_on(mp, Mp.device, torch.int32)
    elif regime == "cluster" and eigvecs:  # the angle log: (c, flag, s, flag) entries
        log = torch.zeros((nb, nrounds, mp // 2, 4), dtype=torch.int32, device=Mp.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    with torch.cuda.device(Mp.device):
        stream = torch.cuda.current_stream().cuda_stream
        if eigvecs:
            fn = lib.lt_jacobi_eigh_f32
            rc = fn(A.data_ptr(), ptr(a2), *(o.data_ptr() for o in outs), ptr(table), ptr(log),
                    nb, mp, nrounds, REGIMES.index(regime), stream)
        else:
            fn = lib.lt_jacobi_bounds_f32
            rc = fn(A.data_ptr(), ptr(a2), *(o.data_ptr() for o in outs), ptr(table),
                    nb, mp, nrounds, REGIMES.index(regime), stream)
    if rc == -1:
        raise RuntimeError(
            f"{fn.__name__}: no cluster of {CLUSTER} blocks with "
            f"{smem_bytes(regime, mp, eigvecs)} bytes of shared memory each can be resident "
            f"on this card{' in pairs' if eigvecs else ''} (cudaOccupancyMaxActiveClusters)")
    if rc == -2:
        raise RuntimeError(f"{fn.__name__}: mp={mp} does not fit regime {regime!r}")
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {rc}")


def jacobi_eigh_cuda(Mp: torch.Tensor, sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1 on the card: same contract as `jacobi_eigh_plain`."""
    _check_padded(Mp)
    nb, mp, _ = Mp.shape
    regime = regime_for(nb, mp, True)
    VT = torch.empty_like(Mp)
    lam = torch.empty((nb, mp), dtype=torch.float32, device=Mp.device)
    _run(True, Mp, (VT, lam), sweeps, regime)
    jacobi_eigh_cuda.launches_by_mp[mp] += 1
    jacobi_eigh_cuda.launches_by_regime[regime] += 1
    return lam, VT


def jacobi_bounds_cuda(Mp: torch.Tensor, sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2 on the card: same contract as `jacobi_bounds_plain`."""
    _check_padded(Mp)
    nb, mp, _ = Mp.shape
    regime = regime_for(nb, mp, False)
    g = torch.empty((nb, mp), dtype=torch.float32, device=Mp.device)
    h = torch.empty_like(g)
    _run(False, Mp, (g, h), sweeps, regime)
    jacobi_bounds_cuda.launches_by_mp[mp] += 1
    jacobi_bounds_cuda.launches_by_regime[regime] += 1
    return g, h


# launch counts per padded size mp (a problem with several block groups
# launches each kernel at several mp in one iteration; the total is the
# sum) and per regime
for _fn in (jacobi_eigh_cuda, jacobi_bounds_cuda):
    _fn.launches_by_mp = collections.Counter()
    _fn.launches_by_regime = collections.Counter()


def _route(Mp: torch.Tensor, plain, cuda, sweeps: int):
    if Mp.device.type == "cpu":
        return plain(Mp, sweeps)
    if Mp.device.type == "cuda":
        return cuda(Mp, sweeps)
    raise ValueError(f"no Jacobi route for device {Mp.device}")


def jacobi_eigh_padded(Mp: torch.Tensor, sweeps: int):
    """B1: the kernel for a CUDA tensor, the plain version for a CPU one."""
    return _route(Mp, jacobi_eigh_plain, jacobi_eigh_cuda, sweeps)


def jacobi_bounds_padded(Mp: torch.Tensor, sweeps: int):
    """B2: the kernel for a CUDA tensor, the plain version for a CPU one."""
    return _route(Mp, jacobi_bounds_plain, jacobi_bounds_cuda, sweeps)


# --------------------------------------------------------------------------
# wrappers (jacobi_pallas.py: eigh_pallas_f32, eig_bounds_pallas)
# --------------------------------------------------------------------------


def _normalize_pad(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gershgorin normalization (spectrum into [-1, 1]) and the decoupled
    sentinel pad to mp = max(round_up(m, 16), 16)."""
    nb, m, _ = M.shape
    scale = M.abs().sum(-1).amax(-1).clamp_min(1e-300)  # [nb]
    Mn = (M / scale[:, None, None]).to(torch.float32)
    mp = max(_round_up(m, 16), 16)
    if mp != m:
        Mp = torch.zeros((nb, mp, mp), dtype=torch.float32, device=M.device)
        Mp[:, :m, :m] = Mn
        idx = torch.arange(m, mp, device=M.device)
        Mp[:, idx, idx] = _SENTINEL
        Mn = Mp
    return Mn, scale


def _sorted_eigh(lam, VT, m: int, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1 output -> (lam [nb, m] ascending and rescaled, V [nb, m, m]).
    Pads (sentinel 2.0) sort last; stable like jnp.argsort."""
    nb = lam.shape[0]
    order = torch.argsort(lam, dim=-1, stable=True)[:, :m]
    lam = torch.gather(lam, -1, order)
    V = VT.mT[:, :m, :]  # columns = eigenvectors
    V = torch.gather(V, -1, order[:, None, :].expand(nb, m, m))
    return lam * scale[:, None].to(torch.float32), V


def _widened_bounds(g, h, m: int, scale, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2 output -> certified (lo, hi) per matrix: min/max over the real rows
    (pad rows stay decoupled, their sentinel would dominate the max), widened
    by the f32 backward-error margin and scaled back."""
    lo = g[:, :m].amin(-1).to(dtype)
    hi = h[:, :m].amax(-1).to(dtype)
    margin = _EIGMIN_MARGIN_C * float(np.finfo(np.float32).eps) * float(np.sqrt(m))
    return (lo - margin) * scale, (hi + margin) * scale


def eigh_jacobi_f32(M: torch.Tensor, sweeps: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 eigendecomposition seed of a batch of symmetric matrices
    (`jacobi_pallas.py:eigh_pallas_f32`).

    M: [nb, m, m], any float dtype. Returns (lam [nb, m] ascending,
    V [nb, m, m]) in f32 with M ~ V diag(lam) V^T to ~1e-7 * ||M||: a seed
    for `eigh_mixed`'s f64 refinement, not full f64 accuracy."""
    m = M.shape[-1]
    Mn, scale = _normalize_pad(M)
    lam, VT = jacobi_eigh_padded(Mn, jacobi_sweeps_for(m) if sweeps is None else sweeps)
    return _sorted_eigh(lam, VT, m, scale)


def eig_bounds_jacobi(M: torch.Tensor, sweeps: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Certified-up-to-f32-rounding bounds lo <= lambda_min, hi >= lambda_max
    per matrix (`jacobi_pallas.py:eig_bounds_pallas`): Gershgorin bounds of
    the Jacobi-rotated matrix, widened by 32 * eps32 * sqrt(m) and scaled
    back. Returns ([nb], [nb]) in M.dtype."""
    m = M.shape[-1]
    Mn, scale = _normalize_pad(M)
    g, h = jacobi_bounds_padded(Mn, bound_sweeps_for(m) if sweeps is None else sweeps)
    return _widened_bounds(g, h, m, scale, M.dtype)

