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

The kernel has five regimes, chosen by the shape and the card's SM count
(`regime_for`): "sm" (one block per matrix in shared memory), "dsmem" (one
16-block cluster of 256 threads a block per matrix, rows and eigenvector
rows spread over its blocks, each round's exchange pushed into the peers'
shared memory and waited for on each block's own barrier), "cluster" (one
16-block cluster of 1024 threads a block per matrix, no cluster barrier:
each round's angles, leaving rows and edge values go as bulk copies onto
the receiver's barrier while the block rotates, warps specialised to the
angles, the copies and the rotation; B1 adds a cluster for the
eigenvector rows, which replays the angles from a log in global memory;
the faster from mp 304 (B1) or 464 (B2) to 912, csrc/jacobi.cu note (b)),
"grid" (one cooperative launch over the card,
past a cluster's capacity, where the card's SMs hold the rows) and, past
that, "rounds" (one launch per round). In every regime but "rounds" a call
is one launch of the Jacobi kernel (a "grid" call with more matrices than
one launch holds runs them in turns).
Each regime rounds every operation once in the plain version's order, so
on the card B1 equals the plain version bit for bit and B2 differs only by
the order of the Gershgorin row sums.

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
    "grid_plan",
    "grid_pairs",
    "sm_count",
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


# The kernel's regimes, chosen by the shape (csrc/jacobi.cu's note):
# "sm", one block per matrix in shared memory; "cluster", one cluster of
# CLUSTER blocks of 1024 threads per matrix with no cluster barrier a round
# (B1 adds a second cluster for the eigenvector rows); "grid", one
# cooperative launch of a block on each SM, beyond a cluster's capacity;
# "rounds", one launch per round, beyond the grid's; "dsmem", one cluster of
# CLUSTER blocks of 256 threads per matrix with no cluster barrier a round,
# at the small sizes where it is the fastest.
# "grid"'s capacity depends on the card's SMs; without a card the shape rule
# assumes H100_SMS.
# The index in REGIMES is the C side's regime code.
REGIMES = ("rounds", "sm", "cluster", "grid", "dsmem")
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use on Hopper
CLUSTER = 16  # blocks a "cluster" or "dsmem" cluster (csrc/jacobi.cu::wide::BLOCKS, dsmem::BLOCKS)
H100_SMS = 132  # SMs of an H100 SXM
EDGE = 12  # edge values a "grid" or "dsmem" block keeps ("cluster": the same in 24 slots)


def _ceil_div(x: int, k: int) -> int:
    return -(-x // k)


def cluster_pairs(mp: int) -> list:
    """[lo_b, hi_b) of the pair positions block b of a cluster owns (its rows
    are the top positions lo_b..hi_b-1 and the bottom ones mp/2 + lo_b..);
    csrc/jacobi.cu::pair_lo."""
    half = mp // 2
    return [(b * half // CLUSTER, (b + 1) * half // CLUSTER) for b in range(CLUSTER)]


def grid_pairs(mp: int, blocks: int) -> list:
    """[lo_b, hi_b) of the pair positions block b of a "grid" matrix (or a
    "dsmem" cluster) owns (csrc/jacobi.cu::pair_lo with ``blocks`` blocks)."""
    half = mp // 2
    return [(b * half // blocks, (b + 1) * half // blocks) for b in range(blocks)]


def _dsmem_bytes(mp: int, eigvecs: bool) -> int:
    """csrc/jacobi.cu::dsmem::bytes: two mbarriers, A's rows [S][mp] with S
    = 2 KM + 2, KM = ceil(mp/2 / CLUSTER) (and the eigenvector rows beside
    them for B1), row records [KM] (16 B), the angles [3][mp/2] (8 B), the
    labels by position [2][mp] and label_src's table [mp], three slot tables
    [2][3 S] and their gather map [3 S], two sets of edge values."""
    pairs = _ceil_div(mp // 2, CLUSTER)
    slots = 2 * pairs + 2
    return (16 + 4 * slots * mp * (2 if eigvecs else 1) + 16 * pairs + 24 * mp + 36 * slots
            + 8 * EDGE)


def _cluster_bytes(mp: int) -> int:
    """csrc/jacobi.cu::wide::bytes, a block of a "cluster" matrix: three
    mbarriers (32 B), A's rows [S][mp] with S = 2 KM + 2, KM = ceil(mp/2 /
    CLUSTER), row records [2][KM] (16 B), the angles [3][CLUSTER][KM
    rounded up to even] (8 B), warp 0's lane table [32] (16 B), the edge
    values received [2][24] and sent [2][12] (4 B), the slot table [2][S]
    (2 B)."""
    pairs = _ceil_div(mp // 2, CLUSTER)
    slots = 2 * pairs + 2
    return (32 + 4 * slots * mp + 32 * pairs + 24 * CLUSTER * 2 * _ceil_div(pairs, 2) + 512
            + 8 * 36 + 4 * slots)


def _consumer_bytes(mp: int) -> int:
    """csrc/jacobi.cu::wide::consumer_bytes, a block of B1's consumer
    cluster in "cluster": mp eigenvector rows of ceil(mp/16) columns (rounded
    up to even), two rounds of angles (8 B a pair) and labels (4 B)."""
    return 4 * mp * 2 * _ceil_div(_ceil_div(mp, CLUSTER), 2) + 12 * mp


def _dsmem_fits(mp: int, eigvecs: bool) -> bool:
    """A "dsmem" block needs two pairs (from mp 64), at most 32 (one warp of
    angle threads), and its shared memory (B1 to mp 640)."""
    half = mp // 2
    return (half // CLUSTER >= 2 and _ceil_div(half, CLUSTER) <= 32
            and _dsmem_bytes(mp, eigvecs) <= SMEM_LIMIT)


def _grid_bytes(mp: int, blocks: int, vsmem: bool) -> int:
    """csrc/jacobi.cu::grid_bytes: row records [2][KM] (16 B), A's rows
    [2 KM + 2][mp] (and the eigenvector rows' beside them where ``vsmem``),
    the round's angles (8 B a pair), labels [2][mp/2], two slot tables and
    the edge values."""
    pairs = _ceil_div(mp // 2, blocks)
    slots = 2 * pairs + 2
    return 32 * pairs + 4 * slots * mp * (2 if vsmem else 1) + 8 * mp + 8 * slots + 4 * EDGE


def grid_plan(nb: int, mp: int, eigvecs: bool, sms: int = H100_SMS) -> dict:
    """csrc/jacobi.cu::grid_plan, the "grid" regime's layout of nb matrices
    at padded size mp on a card of ``sms`` SMs, one block each: ``per``
    matrices a launch holds at once (the rest in further launches),
    ``blocks`` per matrix, ``vsmem`` (B1's eigenvector rows in shared memory
    beside A's, else in global memory) and ``fits``. As many matrices at
    once as leave each enough of the blocks for its rows; a block needs two
    pairs and at most 32 (one warp of angle threads)."""
    half = mp // 2

    def fits(g):
        return (g >= 1 and half // g >= 2 and _ceil_div(half, g) <= 32
                and _grid_bytes(mp, g, False) <= SMEM_LIMIT)

    def blocks_for(per):
        return min(sms // per, half // 2)

    per = min(nb, sms)
    while per > 1 and not fits(blocks_for(per)):
        per -= 1
    per = max(per, 1)
    blocks = blocks_for(per)
    vsmem = eigvecs and _grid_bytes(mp, blocks, True) <= SMEM_LIMIT
    return {"per": per, "blocks": blocks, "vsmem": vsmem, "fits": fits(blocks)}


def smem_bytes(regime: str, mp: int, eigvecs: bool, nb: int = 1, sms: int = H100_SMS) -> int:
    """Dynamic shared memory a block of ``regime`` needs (csrc/jacobi.cu's
    sm_bytes, grid_bytes, dsmem::bytes, wide::bytes and
    wide::consumer_bytes): "sm", A's rows at stride mp + 1, the eigenvector
    rows at stride mp, per pair a row record (16 B) and an angle (8 B), both
    double buffered, and two label words; "dsmem", `_dsmem_bytes`;
    "cluster", `_cluster_bytes` (B1: the larger of that and a consumer
    block, `_consumer_bytes`); "grid" depends on nb and the card's SMs
    through `grid_plan`."""
    if regime == "sm":
        return 4 * mp * (mp + 1) + 4 * mp * mp * eigvecs + 28 * mp
    if regime == "cluster":
        rows = _cluster_bytes(mp)
        return max(rows, _consumer_bytes(mp)) if eigvecs else rows
    if regime == "grid":
        plan = grid_plan(nb, mp, eigvecs, sms)
        return _grid_bytes(mp, plan["blocks"], plan["vsmem"])
    if regime == "dsmem":
        return _dsmem_bytes(mp, eigvecs)
    if regime == "rounds":
        return 0
    raise ValueError(f"unknown regime {regime!r}")


# The one-launch regimes' boundaries, timed on an H100 SXM at 700 W (PERF.md
# section 6). "dsmem" from its least size (mp 64: two pairs a block) while one
# wave of its clusters holds every matrix (7 clusters of 16 blocks at once);
# then "cluster" to the size its blocks hold (912), where "grid" takes over.
# Timed against the "cluster" of 1024 threads a block with no cluster barrier,
# ms "dsmem" / "cluster": B2 at mp 448 3.54 / 3.79 and 464 5.54 / 3.86, alike
# for 1 to 7 matrices; B1 at 304 6.49 / 5.73 for 1 to 3 matrices (one wave of
# B1's clusters, two a matrix, holds 3: CLUSTER_PAIRS), but at 4 matrices 400
# 10.62 / 15.83 and at 7 464 20.69 / 29.21. Below mp 304 (B1, few) "dsmem"
# stays where the earlier "cluster" lost to it. B2 for one matrix past mp
# 832, "cluster" / "grid": 848 10.95 / 10.65 and on to 912; for two, 848
# 10.92 / 11.78.
DSMEM_TO = {True: 464, False: 448}
DSMEM_TO_FEW = 288  # B1, up to CLUSTER_PAIRS matrices
CLUSTER_PAIRS = 3
DSMEM_WAVE = 7
CLUSTER_TO_ONE = 832  # B2, one matrix


def regime_for(nb: int, mp: int, eigvecs: bool, sms: int = H100_SMS) -> str:
    """The regime of nb matrices at padded size mp on a card of ``sms``
    SMs: "dsmem" to DSMEM_TO (B1 for up to CLUSTER_PAIRS matrices: to
    DSMEM_TO_FEW) while its blocks fit and one wave of its clusters holds
    the nb matrices; else "sm" where its block fits SMEM_LIMIT (B1 to mp
    160, B2 to 224: below mp 64 or past that wave); else "cluster" where
    its blocks fit (to mp 912; B2 for one matrix to CLUSTER_TO_ONE); else
    "grid" where the card holds its plan (to mp 2400 on 132 SMs); else
    "rounds"."""
    dsmem_to = DSMEM_TO_FEW if eigvecs and nb <= CLUSTER_PAIRS else DSMEM_TO[eigvecs]
    if nb <= DSMEM_WAVE and mp <= dsmem_to and _dsmem_fits(mp, eigvecs):
        return "dsmem"
    if smem_bytes("sm", mp, eigvecs) <= SMEM_LIMIT:
        return "sm"
    grid = grid_plan(nb, mp, eigvecs, sms)["fits"]
    if smem_bytes("cluster", mp, eigvecs) <= SMEM_LIMIT and not (
            not eigvecs and nb == 1 and mp > CLUSTER_TO_ONE and grid):
        return "cluster"
    if grid:
        return "grid"
    return "rounds"


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("jacobi")
    if not getattr(lib, "_lt_bound", False):
        for fn in (lib.lt_jacobi_eigh_f32, lib.lt_jacobi_bounds_f32):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.lt_jacobi_grid_scratch.argtypes = [ctypes.c_int] * 3
        lib.lt_jacobi_grid_scratch.restype = ctypes.c_longlong
        lib._lt_bound = True
    return lib


def _check_padded(Mp: torch.Tensor) -> None:
    if Mp.dtype != torch.float32 or Mp.ndim != 3 or Mp.shape[1] != Mp.shape[2]:
        raise ValueError(f"expected [nb, mp, mp] float32, got {tuple(Mp.shape)} {Mp.dtype}")
    if Mp.shape[1] % 16 or Mp.shape[1] < 16:
        raise ValueError(f"mp must be a multiple of 16, got {Mp.shape[1]}")


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device ("grid" plans one block on each)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _run(eigvecs: bool, Mp: torch.Tensor, outs, sweeps: int, regime: str) -> None:
    """Launch B1 (eigvecs) or B2 on Mp in ``regime``, writing ``outs``
    (B1: VT, lam; B2: g, h). Scratch comes from torch (zeroed where it
    holds flagged entries); the kernel allocates nothing. Raises on any
    launch error."""
    nb, mp, _ = Mp.shape
    nrounds = sweeps * (mp - 1)
    A = Mp.contiguous()
    a2 = table = scratch = None
    lib = _lib()
    if regime == "rounds":  # the round kernel works on two A buffers in turn
        A = A.clone()
        a2 = torch.empty_like(A)
        table = _table_on(mp, Mp.device, torch.int32)
    elif regime == "cluster" and eigvecs:  # the angle log: (c, flag, s, flag) entries
        scratch = torch.zeros((nb, nrounds, mp // 2, 4), dtype=torch.int32, device=Mp.device)
    elif regime == "grid":  # the exchange buffers between rounds: flagged entries
        with torch.cuda.device(Mp.device):
            n = lib.lt_jacobi_grid_scratch(nb, mp, int(eigvecs))
        if n < 0:
            raise RuntimeError(f"mp={mp} (nb={nb}) does not fit regime 'grid' on this card")
        scratch = torch.zeros(n, dtype=torch.int32, device=Mp.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(Mp.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (A.data_ptr(), ptr(a2), *(o.data_ptr() for o in outs), ptr(table), ptr(scratch),
                nb, mp, nrounds, REGIMES.index(regime), stream)
        fn = lib.lt_jacobi_eigh_f32 if eigvecs else lib.lt_jacobi_bounds_f32
        rc = fn(*args)
    if rc == -1:
        if regime == "grid":
            plan = grid_plan(nb, mp, eigvecs, sm_count(Mp.device))
            raise RuntimeError(
                f"{fn.__name__}: a grid of {plan['per'] * plan['blocks']} blocks with "
                f"{_grid_bytes(mp, plan['blocks'], plan['vsmem'])} bytes of "
                f"shared memory each cannot be resident on this card at once "
                f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
        if regime == "dsmem":
            raise RuntimeError(
                f"{fn.__name__}: no cluster of {CLUSTER} blocks with "
                f"{_dsmem_bytes(mp, eigvecs)} bytes of shared memory each can be "
                f"resident on this card (cudaOccupancyMaxActiveClusters)")
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
    regime = regime_for(nb, mp, True, sm_count(Mp.device))
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
    regime = regime_for(nb, mp, False, sm_count(Mp.device))
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

