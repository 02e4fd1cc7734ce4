"""Per-iteration flop model for the IPM step — makes "actually fast" auditable.
Port of `loraine_tpu/utils/flops.py`: the same counts, arithmetic on the
problem's shapes; `utilization` divides by the H100's f64 peak instead.

Counts the f64 flops of one predictor-corrector iteration from the problem
structure (BASELINE.md performance-facts table; complexities from the
reference's own accounting, `docs/src/low-rank_data.md:9`):

  Schur assembly   dense   4 nb n m^3 + 2 nb n^2 m^2   (`src/makeBBBB.jl:24-36`)
                   rank-1  2 nb n m^2 + 2 nb n^2 m     (`src/makeBBBB.jl:1-20`)
                   sparse  2 nb n s m^2 + 2 nb n^2 s   (gather pipeline,
                                                        ops/schur.py:_schur_sparse)
                   LP      2 p n^2
  factorization    chol(H) n^3/3 + explicit tri_inv n^3/3
  NT scaling       chol(X) nb m^3/3 + eigendecomposition ~EIG_C nb m^3
  steplengths      2 spectral-range computations on [2 nb, m, m] stacks
                   (predictor + corrector) ~ 2 EIG_C (2 nb) m^3

One multiply-add = 2 flops. EIG_C = 9 is the classical tridiagonalization+QR
n^3 constant; the in-house Jacobi/bound kernels do MORE arithmetic than this
(sweeps x rotations), so reported utilization is conservative (never
flattered). Solves, residuals, RHS and elementwise work are O(n^2)/O(nb m^2)
and omitted. kit=1 adds the H_alpha preparation (one eigendecomposition of W
per block, the SMW small matrix) and per-CG-iteration matvecs; the
materialized small-n CG's per-iteration cost is 2 n^2.
"""
from __future__ import annotations

EIG_C = 9.0  # n^3 coefficient of a full symmetric eigendecomposition

# the f64 rate `utilization` divides by: one NVIDIA H100 SXM's published
# dense f64 tensor-core peak, 67 TFLOP/s at its full 700 W power limit
# (NVIDIA's data sheet; cuBLAS DGEMM runs on the tensor cores). A card set
# below 700 W (`nvidia-smi --query-gpu=power.limit`) reaches less, so a
# utilization is reported with the card's name and power limit beside it.
H100_F64_PEAK_FLOPS = 67.0e12


def group_stats(group):
    """(nb, m, storage, s) for a BlockGroup; s = COO slots for sparse."""
    nb = group.nb
    if group.is_rank1:
        return nb, group.m, "rank1", 0
    if group.is_sparse:
        return nb, group.m, "sparse", group.Avals.shape[-1]
    return nb, group.m, "dense", 0


def assembly_flops(problem) -> float:
    """One Schur-matrix assembly (H is assembled once per iteration; the
    corrector reuses it)."""
    n = problem.n
    total = 0.0
    for g in problem.groups:
        nb, m, kind, s = group_stats(g)
        if kind == "rank1":
            total += 2.0 * nb * n * m * m + 2.0 * nb * n * n * m
        elif kind == "sparse":
            total += 2.0 * nb * n * s * m * m + 2.0 * nb * n * n * s
        else:
            total += 4.0 * nb * n * m**3 + 2.0 * nb * n * n * m * m
    if problem.nlin:
        total += 2.0 * problem.nlin * n * n
    return total


def factorization_flops(problem) -> float:
    n = problem.n
    return n**3 / 3.0 + n**3 / 3.0  # chol + explicit inv(L)


def nt_flops(problem) -> float:
    total = 0.0
    for g in problem.groups:
        nb, m, _, _ = group_stats(g)
        total += nb * m**3 / 3.0 + EIG_C * nb * m**3
    return total


def steplength_flops(problem) -> float:
    total = 0.0
    for g in problem.groups:
        nb, m, _, _ = group_stats(g)
        total += 2.0 * EIG_C * (2.0 * nb) * m**3
    return total


def iteration_flops(problem, kit: int = 0, cg_iters_per_ipm: float = 0.0) -> dict:
    """Flop budget of one IPM iteration, by phase. For kit=1 the
    factorization is replaced by H_alpha prep (eigendecomposition of W per
    block + the small SMW factorization) + CG matvecs on the materialized
    [n, n] operator."""
    asm = assembly_flops(problem)
    nt = nt_flops(problem)
    steps = steplength_flops(problem)
    if kit == 0:
        fact = factorization_flops(problem)
        cg = 0.0
    else:
        fact = 0.0
        for g in problem.groups:
            nb, m, _, _ = group_stats(g)
            fact += EIG_C * nb * m**3  # eigh(W) in the H_alpha prep
        fact += problem.n**3 / 3.0  # SMW small-matrix Cholesky class
        cg = cg_iters_per_ipm * 2.0 * problem.n**2
    total = asm + fact + nt + steps + cg
    return {
        "assembly": asm,
        "factorization": fact,
        "nt_scaling": nt,
        "steplengths": steps,
        "cg": cg,
        "total": total,
    }


def utilization(flops_per_iter: float, sec_per_iter: float) -> float:
    """Achieved fraction of the H100's f64 peak."""
    if sec_per_iter <= 0:
        return 0.0
    return flops_per_iter / sec_per_iter / H100_F64_PEAK_FLOPS
