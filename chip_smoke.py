#!/usr/bin/env python3
"""Smoke test of loraine_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and no network, and exits non-zero on the first failed check.

Phases:
  1. setup: card name and power limit, build of the CUDA kernels
     (csrc/jacobi.cu and csrc/pcg.cu, one nvcc each for sm_90a, started
     together) from the checkout.
  2. each Jacobi kernel against its plain PyTorch version on the card, at
     the solver's shapes (nb, m) in {(1, 16), (2, 16), (1, 56), (2, 56),
     (1, 144), (1, 152), (1, 800), (2, 800), (1, 808)} (tru3, vib3 and
     control1, theta1, vib9's and tru9's groups, maxG11, thetaG11) and at
     the edges of the kernel's regimes, (1, 128), (4, 144), (1, 176),
     (1, 192), (1, 912) and (1, 1000) (B1: "sm" below mp 144 or past one
     wave of clusters, "cluster" to 912, then "rounds"; B2: "sm" below 192),
     on clustered (IPM-like) and random spectra: the contracts, whether B1
     equals the plain version bit for bit, the kernel's, the "rounds"
     regime's (one launch per round), the plain version's and the library
     call's times (torch.linalg.eigh / eigvalsh in f32 on the same tensor)
     and the bound, and, where the other one-launch regime also fits, its
     time; fails unless every regime of both kernels ran.
  3. SDPLIB theta1 (n=104, one 50x50 block) through ``solve_sdpa`` on the
     card: OPTIMAL at 23.0, and the same trajectory as the CPU run of the
     port (plain Jacobi versions) on the same input.
  4. SDPLIB maxG11 (n=800, one 800x800 block, rank-1 data) through
     ``solve_sdpa`` on the card: OPTIMAL at 629.16479325 in 14 +- 2
     iterations (the JAX package's CPU run).
  5. kernel launch counts of phases 3-4 (every solve phase prints its
     launches per kernel, per padded size mp, per regime and per
     iteration).
  6. each CG kernel (B3 f64 min-residual, B4 f32, the f64 polish) in every
     regime that fits ("block", "cluster" of 8 and of 16 blocks, "grid")
     against its plain version on the card, at n in {21, 36, 104, 464,
     1000} (control1, tru3/vib3, theta1, theta_G100; "grid" beyond): B3
     and B4 inside their refinement wrappers, the polish on Hp u = Mli b;
     (a) identity preconditioner, kappa 1e3, tol 1e-10; (b) Mli =
     inv(chol(H + 1e-6 I)), kappa(H) 1e8, tol 1e-12 (B3, polish) and 1e-9
     (B4); fails unless every regime of each kernel ran. Then one full
     solve of each body in every regime that fits at n in {21, 36, 104,
     128, 160, 256, 464, 512, 1000}, timed beside the plain version,
     torch.linalg.solve on the same system and the bound ("grid" is the
     kernel of the first port; beside the polish kernel, the eager f64
     loop it replaced).
  7. SDPLIB control1 with the CG path (kit=1, `bench.py` options) on the
     card: OPTIMAL at 17.78463, beside the port's CPU run; B3 in "block".
  8. theta1 with the CG path, materialized (B3 in "block", and the polish
     kernel) and matrix-free (SMW H_alpha) routes: OPTIMAL at 23.0.
  9. theta_G100, a Lovasz theta SDP at SDPLIB theta2's size (100 vertices,
     463 edges from a seed, n=464, one 100x100 block), kit=1 (B3 in
     "cluster") and kit=0 on the card: both OPTIMAL, objectives within 1e-5
     relative; kit=1 prints the CG iterations of B3 and of the polish per
     IPM iteration.
 10. control1 with the f32 CG kernel (cg_kernel='pallas', loose options).
 11. SDPLIB tru9 at full size (n=3240, one 145x145 block padded to 152,
     6480 LP variables; sparse COO storage by the auto rule; `bench.py`
     options): OPTIMAL at 0.05975333 in 22 +- 2 iterations.
 12. SDPLIB vib9 at full size (blocks 145 and 144 in two groups, padded 152
     and 144; Jacobi mp 160 and 144; 6480 LP variables; sparse): OPTIMAL at
     0.01276683 in 34 +- 2 iterations, with B1 and B2 launched at both mp.
 13. SDPLIB tru3 and vib3 (LP cone, n=36) with kit=0 and kit=1 (control1-cg
     options, materialized route: B3 in "block" and the polish) on the
     card beside the port's CPU run: all OPTIMAL, iteration counts within
     one.
 14. the sparse adjoint and the sparse Schur assembly, each called twice on
     tru9's data on the card: bitwise-equal results.
 15. SDPLIB thetaG11 at full size (n=2401, one 801x801 block, rank-1 via
     `datarank=-1`; padded 808, Jacobi mp 816): OPTIMAL at 400.00023146 in
     17 +- 2 iterations.
 16. launch counts of the five kernels over the solve phases.
 17. exactness of the double-double arithmetic on the card (precision
     'dd'/'dd2', `ops/dd.py`, `ops/ozaki.py`): two_sum, two_prod, dd_add,
     dd_sum, slice_operand and acc_matmul on seeded inputs (cancellations,
     spreads of 2^+-300, contractions k = 800 and 2500) equal the CPU's
     results bit for bit, and every Ozaki partial GEMM A_p @ B_q (cuBLAS
     f64, the tensor cores) equals the CPU's and, at a few entries, the
     exact rational value.
 18. theta1 at precision='dd', kit=0: OPTIMAL at eDIMACS 1e-11, objective
     within 1e-9 of 23 and of the dual objective, beside the port's CPU run
     (iterations within one).
 19. dd2: theta1 (dense storage) with err1 < 1e-18 and err3 < 1e-15; tru3
     forced sparse with err1, err3 < 1e-18; the LP synthetic of
     tests/test_precision.py:76-96 below DIMACS 1e-13.
 20. theta1 on the CG path (kit=1) at 'dd' (DIMACS < 1e-9) and 'dd2'
     (< 1e-10): no CG kernel runs under the precision tiers.
 21. maxG11 at full size at precision='dd', eDIMACS 1e-8: OPTIMAL, objective
     within 1e-6 relative of 629.16479325; wall time, median time per
     iteration and peak memory beside phase 4's f64 run.
 22. maxG11 at full size under the modes the JAX package's CPU 'auto'
     resolves to at m = 800 (eigh_backend='mixed': the library's f32 eigh as
     the NT seed; step_eig='exact': eigenvalues of `eigh_mixed`): OPTIMAL,
     objective within 1e-5 relative of 629.16479325, iterations within 2 of
     14, neither Jacobi kernel launched; then with step_eig='pallas' (B2's
     bounds, the same seed): the iterations of both beside phase 4's (B1
     seed, B2 bounds), which tells which mode moves the count.
 23. theta1 under eigh_backend 'jacobi' (the eager f64 Jacobi) and 'xla'
     (the library's f64 eigh), step_eig='exact', each beside the port's CPU
     run under the same modes: same iterations, objectives within 1e-9; no
     Jacobi kernel launched.
 24. theta1 and control1 (kit=0) under step_eig 'chol' and 'lanczos' (B1
     seeds the NT scaling, B2 is not launched), and theta1 under
     nt_method='svd' with eigh_backend='xla' (no B1, B2 for the steps): all
     OPTIMAL but control1 under 'lanczos', which stops at the iteration
     limit (40 here) as the JAX package's CPU run does (its uncertified
     bound oversteps on control1's padded blocks).
 25. dtype='float32': theta1 with tests/test_robustness.py:11's options,
     objective within 5e-2 of 23, B1 and B2 launched on f32 data; theta1
     on the CG path (theta1-cg options, eDIMACS 5e-3): OPTIMAL within 1e-3
     of 23 through B3 and the polish (on f64 copies of the f32 operator).
 26. assembly_precision='f32' on theta1, and 'auto' on tru3 (n = 36 < 512:
     'auto' stays f64) and on tru9 at full size (the LP block in f32, the
     sparse group exact): OPTIMAL, iterations within 2 of the f64 runs of
     phases 3, 13 and 11; the handover iteration to the f64 assembly.
 27. ms per call (CUDA events) and device launches per call (torch.profiler)
     of `eigh_jacobi`, `eigh_mixed` with the library seed and with B1's,
     f64 `torch.linalg.eigh`, `eigmin_lanczos` and `eigmin_chol`, beside the
     B1 and B2 wrappers, at (nb, m) = (2, 50) and (2, 800).

 28. the POEMA-JSON and raw-dict entry at full size: tru9 and vib9 written
     with `write_poema_json` (dicts built as tests/test_poema_io.py's
     `_dict_from_sdpa` does) and solved by `solve_json` on the card with
     phases 11-12's options: OPTIMAL, objectives within 1e-5 relative of
     phases 11 and 12, iterations within 2; the JSON read + dict lowering
     time beside the solve time.
 29. the models and the modeling layer on the card: `solve_maxcut` on
     maxG11's own graph (800 nodes, W_ij = -4 F_0[i,j] from the C block of
     maxG11.dat-s; the storage `maxcut_problem` picks; phase 4's eDIMACS):
     relaxation within 1e-5 relative of 629.1648, and the rounding's cut
     weight; `Model.solve` on a seeded 200-node max-cut against
     `solve_maxcut` on the same graph; `correlation_bounds`; `lp_problem`
     (no LMI block, no Jacobi kernel).
 30. ADMM: `solve_admm` on theta1 (eps 1e-5, the library's f64 eigh in the
     projection): iterations, ms per iteration, objective against 23, with
     err read once a chunk of 100 and (the same iterates) after every
     iteration; then
     the IPM warm-started from an eps 1e-3 ADMM iterate (tests/test_admm.py)
     beside phase 3's iteration count.
 31. checkpoints: maxG11 with maxit=5, `save_state`, `load_state`, resumed on
     the card: objective within 1e-6 relative of phase 4's, iterations
     summed within 3 of phase 4's.
 32. diagnostics: ``timing=2`` on theta1 (kit=0) and control1-cg (kit=1)
     prints the phase table; B2, and on kit=1 B3, launched inside
     `profile_phases`; ``profile_dir`` on theta1 writes a non-empty trace
     that names the Jacobi kernels of csrc/jacobi.cu; `flops.utilization`
     of maxG11's median iteration (phase 4) against the H100's f64 peak.
 33. the CLI: ``python -m loraine_tpu_torch solve tests/data/theta1.dat-s
     --kit 0 --eDIMACS 1e-6 --initpoint 1 --json`` in a subprocess on the
     card: rc 0, OPTIMAL at 23.0.

 34. the ('blocks', 'schur') mesh (`parallel/`, one process per rank): the
     seven gates of `parallel/dryrun.py` (the port of
     `__graft_entry__.dryrun_multichip`) on the card, with 1 rank on NCCL
     (mesh (1, 1): `initialize()` and the plumbing), then 2 and 4 ranks on
     Gloo sharing the card (meshes (2, 1) / (1, 2) and (2, 2) / (1, 4)),
     under the port's 'auto' modes (B1 and B2): each gate's sharded
     objective within its tolerance of the single-rank one (tru3 also at
     the SDPLIB value), the iterations, and each rank's B1/B2/B3 launches
     in the sharded run; B1 and B2 must be non-zero on every rank, and B3
     on every rank in kit=1 gate 2 (Hcg is gathered whole where the rows
     are split, and the CG route is the single-card one).
 35. SDPLIB at full size on the schur axis, 2 ranks (1, 2) on the card:
     maxG11 (n = 800, rank-1) with phase 4's options and tru9 (n = 3240,
     sparse, LP cone: 26 panels of the distributed Cholesky over two
     owners) with phase 11's: OPTIMAL, objectives within 1e-7 relative of
     phases 4 and 11, iterations beside theirs; then one maxG11 step on
     (1, 4) against one rank's (obj, dimacs, alpha, beta to 1e-8).
 36. the 2-process `initialize()` solve (tests/test_distributed.py's
     problem, mesh (2, 1)) on the card through Gloo: OPTIMAL on both ranks,
     objectives equal to 1e-12.
     Gloo moves CUDA tensors through the host, and the ranks time-slice one
     card: the wall times of phases 34-36 measure that, not NCCL scaling.

The reference values of phases 4, 11, 12 and 15 are the JAX package's CPU
runs (`benchmarks/results_cpu_r2.jsonl`). Every solve (phases 3, 4, 7-13,
15, 18-26, 28-33) runs with the launch counts set to 0 just before it and read
just after (phases 34-36: in each rank's own process, around its sharded run), and fails if a kernel of its path was not launched (B1 and B2
in every precision-tier solve) or, in phases 22-24, if a Jacobi kernel ran
where its mode does not resolve to it. The line before
the last two is a JSON object with one entry per kernel; then the card's
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

THETA1 = "tests/data/theta1.dat-s"
MAXG11 = "tests/data/maxG11.dat-s"
CONTROL1 = "tests/data/control1.dat-s"
TRU9 = "tests/data/tru9.dat-s"
VIB9 = "tests/data/vib9.dat-s"
THETAG11 = "tests/data/thetaG11.dat-s"
THETA1_OPT = 23.0  # SDPLIB optimum
MAXG11_OPT = 629.1648  # SDPLIB optimum
CONTROL1_OPT = 17.78463  # SDPLIB optimum
# the JAX package on the CPU: objective, iterations (results_cpu_r2.jsonl)
TRU9_REF = (0.05975333, 22)
VIB9_REF = (0.01276683, 34)
THETAG11_REF = (400.00023146, 17)
MAXG11_REF = (629.16479325, 14)
OBJ_RTOL = 1e-5
SHAPES = [(1, 16), (2, 16), (1, 56), (2, 56), (1, 128), (1, 144), (4, 144), (1, 152),
          (1, 176), (1, 192), (1, 800), (2, 800), (1, 808), (1, 912), (1, 1000)]
# published peaks of one H100 SXM (NVIDIA data sheet, dense): f32 outside the
# tensor cores, f64 on the tensor cores, HBM3
PEAK_F32, PEAK_F64, PEAK_BYTES = 67e12, 67e12, 3.35e12
PCG_SIZES = (21, 36, 104, 464, 1000)
# the sizes phase 6 times the CG bodies at
PCG_TIMED = (21, 36, 104, 128, 160, 256, 464, 512, 1000)
# the sizes the time per CG iteration is fitted over
FIT_SIZES = (104, 160, 256, 464, 512)
# tests/test_pcg_pallas.py:76-82
CONTROL1_F32 = {"kit": 1, "preconditioner": 1, "eDIMACS": 3e-3, "tol_cg_min": 1e-4,
                "initpoint": 1, "verb": 0, "cg_kernel": "pallas", "maxit": 40}
# bench.py:80-83 (tru9, vib9) and :86-87 (thetaG11)
LARGE_KIT0 = {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "verb": 0}
THETAG11_OPTS = dict(LARGE_KIT0, datarank=-1)
# tests/test_torch_lp.py: kit=0 at eDIMACS 1e-7 (tests/test_ipm_e2e.py:54-60)
LP_KIT0 = {"kit": 0, "eDIMACS": 1e-7, "initpoint": 1, "verb": 0}
MAXG11_OPTS = {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "datarank": -1, "verb": 0}
MAXG11_DD = dict(MAXG11_OPTS, eDIMACS=1e-8, precision="dd")
KERNELS = ("B1", "B2", "B3", "B4", "polish")
# the kernels of the kit=1 materialized route (B3 and the polish after it)
KIT1_NEEDS = ("B1", "B2", "B3", "polish")
# what the JAX package's CPU 'auto' resolves to at maxG11's m = 800
MAXG11_JAX_CPU = dict(MAXG11_OPTS, eigh_backend="mixed", step_eig="exact")
THETA1_K0 = {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0}
CONTROL1_K0 = {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "verb": 0}
# tests/test_robustness.py:11
THETA1_F32 = {"kit": 0, "eDIMACS": 5e-3, "initpoint": 1, "verb": 0, "dtype": "float32",
              "maxit": 50}
# the shapes phase 27 times the eigen routines at (theta1's and maxG11's m)
MODE_SHAPES = ((2, 50), (2, 800))
# examples/ex_corr.jl:30-31 (tests/test_models.py)
CORR_REF = (-0.9779977649, 0.8719210472)
# the __global__ kernels of csrc/jacobi.cu (at theta1's mp = 64 B1 and B2
# each launch one sm_kernel: the "sm" regime)
JACOBI_GLOBALS = ("sm_kernel", "cluster_kernel", "round_kernel", "identity_kernel",
                  "diag_kernel", "gersh_kernel")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def spectrum_matrix(kind: str, m: int, nb: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        A = rng.standard_normal((nb, m, m))
        return (A + A.transpose(0, 2, 1)) / 2
    # IPM-like: half the spectrum clustered at 1, a graded tail down to 1e-6
    d = np.concatenate(
        [np.full((nb, m // 2), 1.0), 10.0 ** rng.uniform(-6, 0, (nb, m - m // 2))], axis=1
    )
    Q = np.linalg.qr(rng.standard_normal((nb, m, m)))[0]
    A = Q @ (d[:, :, None] * np.eye(m)) @ Q.transpose(0, 2, 1)
    return (A + A.transpose(0, 2, 1)) / 2


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device time of fn in ms (CUDA events)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def timed_call(fn):
    """(fn's result, device ms of that one call by CUDA events)."""
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def bound_ms(flops: float, nbytes: float, peak: float):
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def jacobi_bound(eigvecs: bool, nb: int, mp: int, sweeps: int):
    """B1/B2: sweeps * (mp - 1) rounds of mp/2 disjoint rotations, 6 f32
    flops per element of A (rows, then columns) and, for B1, 3 per element of
    the eigenvector rows; the input read once, the outputs written once."""
    flops = nb * sweeps * (mp - 1) * (6 + 3 * eigvecs) * mp * mp
    nbytes = 4 * nb * (mp * mp + (mp * mp + mp if eigvecs else 2 * mp))
    return bound_ms(flops, nbytes, PEAK_F32)


def cg_bound(f64: bool, n: int, its: int):
    """B3/B4: `its` CG iterations, each one matvec (2 n^2 flops) and ~10 n
    vector flops; H and b read once, x written once."""
    w = 8 if f64 else 4
    return bound_ms(its * (2 * n * n + 10 * n), w * (n * n + 2 * n), PEAK_F64 if f64 else PEAK_F32)


def regime_ms(tj, eigvecs: bool, Mn, sweeps: int, regime: str, reps: int) -> float:
    """Device ms of one Jacobi call forced into ``regime`` (a comparison:
    the wrappers choose the regime by shape alone)."""
    nb, mp, _ = Mn.shape
    vec = torch.empty((nb, mp), dtype=torch.float32, device=Mn.device)
    outs = (torch.empty_like(Mn), vec) if eigvecs else (vec, torch.empty_like(vec))
    return cuda_ms(lambda: tj._run(eigvecs, Mn, outs, sweeps, regime), reps)


def seed_quality(A, lam, V, scale):
    """(max reconstruction error / scale, max orthogonality error) of an f32
    eigenpair seed, in f64."""
    Vd = V.double()
    recon = ((Vd * lam.double()[:, None, :]) @ Vd.mT - A).abs().amax((-1, -2)) / scale
    eye = torch.eye(V.shape[-1], dtype=Vd.dtype, device=Vd.device)
    return float(recon.max()), float((Vd.mT @ Vd - eye).abs().max())


def kernels_vs_plain(tj) -> dict:
    """Phase 2. Returns per-kernel max errors and, at the maxG11 shapes B1
    (1, 800) and B2 (2, 800), the kernel's time, the plain version's, the
    library call's and the bound."""
    err = {"eigh": 0.0, "bounds": 0.0}
    times = {}
    regimes = {"B1": set(), "B2": set()}
    for nb, m in SHAPES:
        # the shapes past thetaG11's take seconds in the plain versions
        for kind in ("clustered", "random") if m <= 808 else ("clustered",):
            A = torch.from_numpy(spectrum_matrix(kind, m, nb, seed=1000 * nb + m)).cuda()
            Mn, scale = tj._normalize_pad(A)
            mp = Mn.shape[-1]
            s1, s2 = tj.jacobi_sweeps_for(m), tj.bound_sweeps_for(m)
            out_k = tj.jacobi_eigh_cuda(Mn, s1)
            lam_k, V_k = tj._sorted_eigh(*out_k, m, scale)
            out_p, pms_e = timed_call(lambda: tj.jacobi_eigh_plain(Mn, s1))
            lam_p, V_p = tj._sorted_eigh(*out_p, m, scale)
            # same operations, each rounded once: equal unless torch's ops
            # round otherwise on this card (printed, not a contract)
            bitwise = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
            lo_k, hi_k = tj._widened_bounds(*tj.jacobi_bounds_cuda(Mn, s2), m, scale, A.dtype)
            out_p, pms_b = timed_call(lambda: tj.jacobi_bounds_plain(Mn, s2))
            lo_p, hi_p = tj._widened_bounds(*out_p, m, scale, A.dtype)
            torch.cuda.synchronize()
            ev = torch.linalg.eigvalsh(A)  # f64 reference
            sc = scale[:, None]
            e_plain = float(((lam_k.double() - lam_p.double()).abs() / sc).max())
            e_f64 = float(((lam_k.double() - ev).abs() / sc).max())
            recon, orth = seed_quality(A, lam_k, V_k, scale)
            recon_p, orth_p = seed_quality(A, lam_p, V_p, scale)
            b_plain = float((torch.maximum((lo_k - lo_p).abs(), (hi_k - hi_p).abs()) / scale).max())
            slack = float((torch.maximum(ev[:, 0] - lo_k, hi_k - ev[:, -1]) / scale).max())
            slack_p = float((torch.maximum(ev[:, 0] - lo_p, hi_p - ev[:, -1]) / scale).max())
            valid = all(bool((lo <= ev[:, 0]).all() and (hi >= ev[:, -1]).all())
                        for lo, hi in ((lo_k, hi_k), (lo_p, hi_p)))
            reps = 10 if m < 100 else 3
            ms_e = cuda_ms(lambda: tj.jacobi_eigh_cuda(Mn, s1), reps)
            ms_b = cuda_ms(lambda: tj.jacobi_bounds_cuda(Mn, s2), reps)
            # the library calls that compute the same functions (yardsticks
            # only: the port never calls them)
            lib_e = cuda_ms(lambda: torch.linalg.eigh(Mn), reps)
            lib_b = cuda_ms(lambda: torch.linalg.eigvalsh(Mn), reps)
            bnd_e, bnd_b = jacobi_bound(True, nb, mp, s1), jacobi_bound(False, nb, mp, s2)
            # the one-launch-per-round regime at the same shape, and the
            # one-launch regime the shape rule did not pick, where it fits
            old_e = regime_ms(tj, True, Mn, s1, "rounds", reps)
            old_b = regime_ms(tj, False, Mn, s2, "rounds", reps)
            reg_e, reg_b = tj.regime_for(nb, mp, True), tj.regime_for(nb, mp, False)
            for kname, eigvecs, reg, s in (("B1", True, reg_e, s1), ("B2", False, reg_b, s2)):
                other = {"sm": "cluster", "cluster": "sm"}.get(reg)
                # (a cluster needs two pairs a block: mp >= 64)
                if other and mp >= 4 * tj.CLUSTER and \
                        tj.smem_bytes(other, mp, eigvecs) <= tj.SMEM_LIMIT:
                    print(f"phase 2 nb={nb} m={m} mp={mp} {kind}: {kname} {other} regime "
                          f"instead of {reg}: ms={regime_ms(tj, eigvecs, Mn, s, other, reps):.4f}",
                          flush=True)
            regimes["B1"].add(reg_e)
            regimes["B2"].add(reg_b)
            print(
                f"phase 2 nb={nb} m={m} mp={mp} {kind}: B1 {reg_e} sweeps={s1} "
                f"bitwise_equal_plain={bitwise} "
                f"|lam-plain|/scale={e_plain:.2e} |lam-f64|/scale={e_f64:.2e} "
                f"recon={recon:.2e} (plain {recon_p:.2e}) orth={orth:.2e} (plain {orth_p:.2e}) "
                f"ms={ms_e:.4f} rounds_ms={old_e:.4f} plain_ms={pms_e:.1f} eigh_ms={lib_e:.4f} "
                f"bound_ms={bnd_e[0]:.4f} ({bnd_e[1]}) | "
                f"B2 {reg_b} sweeps={s2} |bound-plain|/scale={b_plain:.2e} slack/scale={slack:.2e} "
                f"(plain {slack_p:.2e}) valid={valid} ms={ms_b:.4f} rounds_ms={old_b:.4f} "
                f"plain_ms={pms_b:.1f} "
                f"eigvalsh_ms={lib_b:.4f} bound_ms={bnd_b[0]:.4f} ({bnd_b[1]})",
                flush=True,
            )
            # Kernel and plain version run the same rotations; FMA
            # contraction and summation order differ at f32 rounding, which
            # on a degenerate cluster steers the residual off-diagonal mass.
            # Checks: seed eigenvalues within 5e-5 of the scale of f64 and of
            # the plain version; reconstruction and orthogonality within 1e-4
            # (tests/test_jacobi_pallas.py) or, where the trimmed sweep
            # schedule at m >= 256 leaves the plain version itself above
            # that, no worse than twice the plain version. Bounds: certified,
            # kernel and plain (the safety contract); as a net against a
            # grossly looser kernel, slack below twice the plain bound's or
            # 1e-3 of the scale. Per instance the slack is rounding luck on
            # clustered spectra: over 60 seeds at m=56 the medians were
            # 1.50e-4 (kernel) and 1.43e-4 (plain), the maxima 3.4e-4 and
            # 4.4e-4, and one instance gave 5.0e-4 against 1.0e-4.
            check(e_plain < 5e-5 and e_f64 < 5e-5, f"B1 eigenvalues nb={nb} m={m} {kind}")
            check(recon < max(1e-4, 2 * recon_p) and orth < max(1e-4, 2 * orth_p),
                  f"B1 eigenvectors nb={nb} m={m} {kind}")
            check(valid, f"B2 bounds not certified nb={nb} m={m} {kind}")
            check(slack < max(1e-3, 2 * slack_p), f"B2 bounds loose nb={nb} m={m} {kind}")
            err["eigh"] = max(err["eigh"], e_plain)
            err["bounds"] = max(err["bounds"], b_plain)
            if kind == "clustered" and (nb, m) == (1, 800):
                times["eigh"] = (ms_e, pms_e, lib_e, *bnd_e, reg_e)
            if kind == "clustered" and (nb, m) == (2, 800):
                times["bounds"] = (ms_b, pms_b, lib_b, *bnd_b, reg_b)
    for kname, seen in regimes.items():
        check(seen == set(tj.REGIMES), f"{kname}: regimes {sorted(seen)} ran in phase 2")
    return {"err": err, "times": times}


def cg_system(n: int, cond: float, seed: int):
    """SPD H = Q diag(logspace(0, -log10 cond)) Q^T (tests/test_pcg_pallas.py)
    and a normal rhs, in f64 on the card."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    H = (Q * np.logspace(0, -np.log10(cond), n)) @ Q.T
    H = torch.from_numpy((H + H.T) / 2).cuda()
    return H, torch.from_numpy(rng.standard_normal(n)).cuda()


def cg_regimes(tp, n: int, dtype) -> list:
    """(label, regime, blocks) of every regime of the CG kernel that fits an
    n x n system in ``dtype``: "block", "cluster" at each cluster size,
    "grid" (the first port's kernel)."""
    out = [("block", "block", 1)] if tp._fits("block", n, dtype) else []
    out += [(f"cluster{c}", "cluster", c) for c in tp.CLUSTER_SIZES
            if tp._fits("cluster", n, dtype, c)]
    return out + [("grid", "grid", 1)]


def rule_label(tp, n: int, dtype) -> str:
    """The label of the regime the wrappers pick for n (by shape alone)."""
    reg = tp.regime_for_cg(n, dtype)
    return f"cluster{tp.CLUSTER_BLOCKS}" if reg == "cluster" else reg


# the CG kernels, by their names in `ops/pcg.py::_run`
CG_KERNELS = ("B3", "B4", "polish")


def forced(tp, kernel: str, regime: str, blocks: int):
    """The body of ``kernel`` forced into one regime (a comparison: the
    wrappers choose the regime by shape alone); not counted."""
    if kernel == "B3":
        return lambda Hp, b, tol2, maxiter, stall: tp._run("B3", Hp, b, tol2, maxiter, stall,
                                                           regime, blocks)
    return lambda Hp, b, tol2, maxiter: tp._run(kernel, Hp, b, tol2, maxiter, 0, regime, blocks)


def pcg_vs_plain(tp) -> dict:
    """Phase 6. Each CG kernel, in every regime that fits, against its plain
    version on the same inputs: B3 and B4 inside their refinement wrappers,
    the polish kernel on the split-preconditioned system Hp u = Mli b with
    ||r|| <= tol ||Mli b||. Returns per-kernel max |x - x_plain| /
    max |x_plain|."""
    from loraine_tpu_torch.ops.linalg import sym

    err = dict.fromkeys(CG_KERNELS, 0.0)
    ran = {k: set() for k in CG_KERNELS}
    bodies = {
        "B3": (tp.pcg_kernel_ff, tp.cg_minres_plain, torch.float64),
        "B4": (tp.pcg_kernel_mixed, tp.cg_f32_plain, torch.float32),
    }
    for n in PCG_SIZES:
        for case in ("a", "b"):
            eye = torch.eye(n, dtype=torch.float64, device="cuda")
            if case == "a":
                kappa, tols = 1e3, {"B3": 1e-10, "B4": 1e-10, "polish": 1e-10}
                H, b = cg_system(n, kappa, seed=n)
                Mli = eye
            else:
                # b = H x_true: with a normal b, x ~ kappa |b| and the f64
                # residual b - H x itself is only accurate to ~u kappa ~ 1e-8
                kappa, tols = 1e8, {"B3": 1e-12, "B4": 1e-9, "polish": 1e-12}
                H, x_true = cg_system(n, kappa, seed=n + 1)
                b = H @ x_true
                L = torch.linalg.cholesky(H + 1e-6 * eye)
                Mli = torch.linalg.solve_triangular(L, eye, upper=False)
            Hp = sym(Mli @ H @ Mli.mT)
            rhs = Mli @ b
            for k in CG_KERNELS:
                tol = tols[k]
                if k == "polish":
                    # the polish's own system; its condition number sets
                    # how far two solutions within tol may lie apart
                    A, rhs_k, kap = Hp, rhs, float(torch.linalg.cond(Hp))
                    tol2 = (tol * torch.linalg.norm(rhs)) ** 2
                    xp, ip = tp.cg_f64_plain(Hp, rhs, tol2, 10000)
                else:
                    wrapper, plain, dtype = bodies[k]
                    A, rhs_k, kap = H, b, kappa
                    xp, ip = wrapper(H, Mli, b, tol, 10000, body=plain)
                nrm = float(torch.linalg.norm(rhs_k))
                res_p = float(torch.linalg.norm(rhs_k - A @ xp)) / nrm
                ip = int(ip)
                dtype = torch.float32 if k == "B4" else torch.float64
                for label, regime, blocks in cg_regimes(tp, n, dtype):
                    body = forced(tp, k, regime, blocks)
                    if k == "polish":
                        xk, ik = body(Hp, rhs, tol2, 10000)
                    else:
                        xk, ik = bodies[k][0](H, Mli, b, tol, 10000, body=body)
                    torch.cuda.synchronize()
                    res_k = float(torch.linalg.norm(rhs_k - A @ xk)) / nrm
                    dx = float((xk - xp).abs().max() / xp.abs().max())
                    ik = int(ik)
                    print(f"phase 6 {k} {label} n={n} ({case}) tol={tol:.0e}: res={res_k:.2e} "
                          f"(plain {res_p:.2e}) |x-plain|/|x|={dx:.2e} its={ik} (plain {ip})"
                          + (f" cond(Hp)={kap:.3e}" if k == "polish" else ""), flush=True)
                    # same algorithm, other summation order: both meet the
                    # target, x agrees to kappa * tol * 10, iterations to
                    # 10% + 2
                    what = f"{k} {label} n={n} ({case})"
                    check(res_k <= tol and res_p <= tol, f"{what} residual")
                    check(dx <= kap * tol * 10, f"{what} x vs plain")
                    check(abs(ik - ip) <= 0.1 * ip + 2, f"{what} iterations vs plain")
                    err[k] = max(err[k], dx)
                    ran[k].add(regime)
    for k, seen in ran.items():
        check(seen == set(tp.CG_REGIMES), f"{k}: regimes {sorted(seen)} ran in phase 6")
    return {"err": err}


def pcg_times(tp) -> dict:
    """Phase 6, times. One full solve of each CG body (the wrapper's first
    pass; the polish at the same tolerance) on the kappa = 1e3 system at
    every n of PCG_TIMED, in every regime that fits ("grid" is the first
    port's kernel): the times, the plain version's, the library call that
    solves the same system, the bound; beside the polish kernel the eager
    f64 `cg_plain` loop it replaced (one host read per CG iteration).
    Returns, per kernel, the times at n = 464. Last, per kernel and regime,
    the least-squares fit of the time per CG iteration over n in FIT_SIZES
    as a fixed cost plus a cost per row of Hp a block holds (n in "block",
    ceil(n / C) in a cluster of C blocks; n for "grid")."""
    from loraine_tpu_torch.ops.cg import cg_plain

    times = {}
    per_it = {}  # (kernel, label) -> {n: us per CG iteration}
    for n in PCG_TIMED:
        H, b = cg_system(n, 1e3, seed=n)
        rhs = b / torch.linalg.norm(b)
        tol = 0.25e-10
        tol2 = torch.tensor(tol * tol, dtype=torch.float64, device="cuda")
        for k in CG_KERNELS:
            if k == "B3":
                args, plain = (H, rhs, tol2, 4 * n + 128, tp.stall_limit(n)), tp.cg_minres_plain
            elif k == "B4":
                args, plain = (H.float(), rhs.float(), tol2.float(), 2 * n + 64), tp.cg_f32_plain
            else:
                args, plain = (H, rhs, tol2, 4 * n + 128), tp.cg_f64_plain
            dtype = args[0].dtype
            reps = 20 if n < 200 else 10
            ms, its = {}, {}
            for label, regime, blocks in cg_regimes(tp, n, dtype):
                body = forced(tp, k, regime, blocks)
                ms[label] = cuda_ms(lambda: body(*args), reps)
                its[label] = int(body(*args)[1])
                per_it.setdefault((k, label), {})[n] = 1e3 * ms[label] / max(its[label], 1)
            rule = rule_label(tp, n, dtype)
            plain(*args)  # warm
            plain_ms = cuda_ms(lambda: plain(*args), 1, warmup=False)
            # the library call that solves the same system (yardstick)
            lib_ms = cuda_ms(lambda: torch.linalg.solve(args[0], args[1]), reps)
            bnd = cg_bound(dtype == torch.float64, n, its[rule])
            line = (f"phase 6 time {k} n={n}: {rule} ms={ms[rule]:.4f} its={its[rule]} | "
                    + " ".join(f"{lab} ms={v:.4f} us_per_it={1e3 * v / max(its[lab], 1):.3f} "
                               f"its={its[lab]};" for lab, v in ms.items())
                    + f" | plain_ms={plain_ms:.1f} solve_ms={lib_ms:.4f} "
                    f"bound_ms={bnd[0]:.5f} ({bnd[1]})")
            if k == "polish":
                eager = lambda: cg_plain(lambda v: H @ v, rhs, tol, 4 * n + 128)  # noqa: E731
                ms_e = cuda_ms(eager, 1)
                line += f" | eager cg_plain ms={ms_e:.3f} its={int(eager()[1])}"
            print(line, flush=True)
            if n == 464:
                times[k] = {"ms": ms[rule], "plain_ms": plain_ms, "library_ms": lib_ms,
                            "bound_ms": bnd[0], "bound_by": bnd[1], "regime": rule,
                            "regime_ms": ms}
    for (k, label), us in per_it.items():
        sizes = [n for n in FIT_SIZES if n in us]
        if len(sizes) < 2:
            continue
        blocks = int(label[len("cluster"):]) if label.startswith("cluster") else 1
        rows = np.array([-(-n // blocks) if label != "grid" else n for n in sizes], float)
        (fixed, per_row), *_ = np.linalg.lstsq(np.stack([np.ones_like(rows), rows], 1),
                                               np.array([us[n] for n in sizes]), rcond=None)
        unit = "n" if label == "grid" else "rows of Hp a block holds"
        print(f"phase 6 fit {k} {label} over n={sizes}: us per CG iteration = "
              f"{fixed:.3f} + {per_row:.4f} x {unit}", flush=True)
    return times


@contextlib.contextmanager
def cg_iteration_log(S):
    """Records the CG iteration counts of each call of the B3 wrapper and of
    the polish in `ipm/step.py` (as device tensors: no host read during the
    solve)."""
    log = {"pcg_kernel_ff": [], "_polish": []}
    orig = {k: getattr(S, k) for k in log}

    def wrap(name):
        def g(*a, **kw):
            out = orig[name](*a, **kw)
            log[name].append(out[1])
            return out
        return g

    for k in log:
        setattr(S, k, wrap(k))
    try:
        yield log
    finally:
        for k in log:
            setattr(S, k, orig[k])


class Launches:
    """The kernels' launch counters (the Jacobi kernels count per padded
    size mp, every kernel per regime): reset before each solve, read after,
    summed over the solves."""

    def __init__(self, tj, tp):
        self.jacobi = {"B1": tj.jacobi_eigh_cuda, "B2": tj.jacobi_bounds_cuda}
        self.cg = {"B3": tp.cg_minres_f64_cuda, "B4": tp.cg_f32_cuda, "polish": tp.cg_f64_cuda}
        self.total = dict.fromkeys(KERNELS, 0)

    def run(self, label: str, needs, solve):
        for fn in self.jacobi.values():
            fn.launches_by_mp.clear()
            fn.launches_by_regime.clear()
        for fn in self.cg.values():
            fn.launches = 0
            fn.launches_by_regime.clear()
        r = solve()
        # the Jacobi kernels' launches per padded size mp, and every
        # kernel's per regime, of this solve
        self.by_mp = {k: dict(sorted(fn.launches_by_mp.items())) for k, fn in self.jacobi.items()}
        self.by_regime = {k: dict(sorted(fn.launches_by_regime.items()))
                          for k, fn in {**self.jacobi, **self.cg}.items()}
        got = {k: sum(v.values()) for k, v in self.by_mp.items()}
        got.update({k: fn.launches for k, fn in self.cg.items()})
        for k in KERNELS:
            self.total[k] += got[k]
        # the IPM iterations of the result (a model's ModelResult carries the
        # solver's Result as .raw; a model function's plain values have none)
        its = getattr(r, "iterations", None) or getattr(getattr(r, "raw", None), "iterations",
                                                        None)
        per_it = " ".join(f"{k}={v / its:.2f}" for k, v in got.items()) if its else "n/a"
        print(f"launches in {label}: " + " ".join(f"{k}={v}" for k, v in got.items())
              + f" | by mp: B1 {self.by_mp['B1']} B2 {self.by_mp['B2']}"
              + " | by regime: " + " ".join(f"{k} {v}" for k, v in self.by_regime.items() if v)
              + f" | per iteration ({its}): {per_it}", flush=True)
        check(all(got[k] > 0 for k in needs), f"{label}: a kernel of its path was not launched")
        return r


def check_b3_regime(launches, label: str, regime: str) -> None:
    """The solve just run launched B3 in ``regime`` only."""
    got = launches.by_regime["B3"]
    check(set(got) == {regime}, f"{label}: B3 ran in regimes {got}, expected {regime!r}")


def solve_line(phase: str, r) -> str:
    return (f"phase {phase}: {r.status_name} obj={r.objective!r} it={r.iterations} "
            f"cg_it={r.cg_iterations} solve={r.solve_time:.3f} s "
            f"median_iter_ms={1e3 * float(np.median(r.iteration_times)):.2f} dimacs={r.dimacs:.3e}")


def large_case(launches, phase: str, path: str, opts, ref, ltt, problem=None,
               needs=("B1", "B2")):
    """One full-size solve on the card against the JAX package's CPU
    reference (objective within OBJ_RTOL, iterations within 2 unless ref[1]
    is None, as for another eDIMACS than the reference's); prints the
    wall time, the median time per iteration and the peak device memory.
    Returns (result, wall s, peak MiB)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if problem is None:
        r = launches.run(f"phase {phase}", needs,
                         lambda: ltt.solve_sdpa(path, opts, device="cuda"))
    else:
        r = launches.run(f"phase {phase}", needs,
                         lambda: ltt.solve(problem, opts, device="cuda"))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(solve_line(f"{phase} {path.split('/')[-1]} cuda", r)
          + f" wall(load+solve)={wall:.3f} s peak_mem_MiB={peak:.1f} "
          f"| JAX CPU: obj={ref[0]} it={ref[1]}", flush=True)
    name = path.split("/")[-1]
    check(r.status == 1, f"{name} not OPTIMAL")
    check(abs(r.objective - ref[0]) <= OBJ_RTOL * abs(ref[0]), f"{name} objective")
    check(ref[1] is None or abs(r.iterations - ref[1]) <= 2, f"{name} iterations")
    check(math.isfinite(r.dimacs) and r.dimacs < opts["eDIMACS"], f"{name} DIMACS")
    check(all(bool(np.isfinite(X).all()) for X in r.X), f"{name} primal blocks")
    return r, wall, peak


def sparse_determinism(ltt) -> None:
    """Phase 14: the sparse adjoint (per-cell layout, no float atomics) and
    the sparse Schur assembly, each twice on tru9's data on the card."""
    from loraine_tpu_torch.ops import schur as ts

    p = ltt.load_problem(TRU9, LARGE_KIT0, device="cuda")
    (g,) = p.groups
    rng = np.random.default_rng(14)
    R = torch.from_numpy(rng.standard_normal((g.nb, g.m, g.m))).to(p.device)
    W = R @ R.mT / g.m + torch.eye(g.m, dtype=R.dtype, device=p.device)
    G = torch.linalg.cholesky(W)
    y = torch.from_numpy(rng.standard_normal(p.n)).to(p.device)
    adj = [ts.Aadj(g, y) for _ in range(2)]
    H = [ts.schur_group(g, W, G) for _ in range(2)]
    torch.cuda.synchronize()
    ms_adj = cuda_ms(lambda: ts.Aadj(g, y), 10)
    ms_h = cuda_ms(lambda: ts.schur_group(g, W, G), 3)
    print(f"phase 14 tru9 sparse Aadj {tuple(adj[0].shape)} bitwise_equal="
          f"{torch.equal(adj[0], adj[1])} ms={ms_adj:.3f} | _schur_sparse {tuple(H[0].shape)} "
          f"bitwise_equal={torch.equal(H[0], H[1])} ms={ms_h:.2f}", flush=True)
    check(torch.equal(adj[0], adj[1]), "sparse Aadj not bitwise reproducible")
    check(torch.equal(H[0], H[1]), "sparse Schur assembly not bitwise reproducible")
    check(bool(torch.isfinite(H[0]).all()), "sparse Schur assembly not finite")


def _spread(rng, shape, lo=-300, hi=300):
    """Normals scaled by 2^[lo, hi): spreads of 2^+-300."""
    return rng.standard_normal(shape) * 2.0 ** rng.integers(lo, hi, shape)


def _bitwise(name: str, card, cpu) -> None:
    """The card's tensors (a tensor or a tuple of them) equal the CPU's
    bit for bit."""
    card = card if isinstance(card, tuple) else (card,)
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
    check(same, f"phase 17: {name} differs between the card and the CPU")


def exactness_probe() -> dict:
    """Phase 17. The error-free transforms and the Ozaki GEMM on the card
    against the same calls on the CPU (bit for bit), and each Ozaki partial
    GEMM against its exact rational value at a few entries. Returns the
    number of partial GEMMs checked and the largest |card - exact|."""
    from fractions import Fraction

    from loraine_tpu_torch.ops import dd as D, ozaki as Z

    rng = np.random.default_rng(17)
    T = lambda x: torch.from_numpy(x)  # noqa: E731
    # adversarial elementwise inputs: spreads of 2^+-300, exact cancellations
    a = _spread(rng, (64, 1001))
    b = _spread(rng, (64, 1001))
    b[:, ::3] = -a[:, ::3] * (1 + 2.0**-52 * rng.standard_normal((64, 334)).round())
    for name, f in (("two_sum", D.two_sum), ("two_prod", D.two_prod)):
        _bitwise(name, f(T(a).cuda(), T(b).cuda()), f(T(a), T(b)))
    x = D.DD(T(a), T(b) * 2.0**-60)
    y = D.DD(T(b), T(a) * 2.0**-60)
    xc, yc = (D.DD(v.hi.cuda(), v.lo.cuda()) for v in (x, y))
    _bitwise("dd_add", D.dd_add(xc, yc), D.dd_add(x, y))
    _bitwise("dd_sum", D.dd_sum(xc, -1), D.dd_sum(x, -1))
    _bitwise("dd_sum axis 0", D.dd_sum(yc, 0), D.dd_sum(y, 0))
    # the Ozaki GEMM at the maxG11 contraction (k = 800, beta 21, 6 slices)
    # and at k = 2500 (beta 20), on spread and on cancelling data
    n_parts, worst = 0, 0.0
    for (m, k, n), spread in (((800, 800, 800), 8), ((96, 2500, 64), 300)):
        A = _spread(rng, (m, k), -spread, spread)
        B = _spread(rng, (k, n), -spread, spread)
        A[:, 1::2] = -A[:, ::2][:, : A[:, 1::2].shape[1]]  # exact cancellation pairs
        beta, nsl = Z._slice_params(k, 106)
        As, Bs = Z.slice_operand(T(A), -1, beta, nsl), Z.slice_operand(T(B), -2, beta, nsl)
        Asc = Z.slice_operand(T(A).cuda(), -1, beta, nsl)
        Bsc = Z.slice_operand(T(B).cuda(), -2, beta, nsl)
        _bitwise(f"slice_operand k={k}", tuple(Asc + Bsc), tuple(As + Bs))
        _bitwise(f"acc_matmul k={k}", tuple(Z.acc_matmul(T(A).cuda(), T(B).cuda())),
                 tuple(Z.acc_matmul(T(A), T(B))))
        entries = [(0, 0), (m // 2, n // 3), (m - 1, n - 1)]
        for t in range(2 * nsl - 1):
            if (t + 2) * beta > 106 + 2 * beta:  # acc_matmul's truncation
                break
            for p_ in range(max(0, t - nsl + 1), min(t, nsl - 1) + 1):
                q = t - p_
                part = (Asc[p_] @ Bsc[q]).cpu()
                _bitwise(f"partial GEMM ({p_},{q}) k={k}", part, As[p_] @ Bs[q])
                for i, j in entries:
                    exact = sum((Fraction(float(u)) * Fraction(float(v))
                                 for u, v in zip(As[p_][i].tolist(), Bs[q][:, j].tolist())),
                                Fraction(0))
                    worst = max(worst, abs(float(Fraction(float(part[i, j])) - exact)))
                    check(Fraction(float(part[i, j])) == exact,
                          f"phase 17: partial GEMM ({p_},{q}) k={k} at {(i, j)} is not exact")
                n_parts += 1
    print(f"phase 17 exactness: two_sum two_prod dd_add dd_sum slice_operand acc_matmul "
          f"bitwise equal card/CPU; {n_parts} Ozaki partial GEMMs (k=800, 2500) equal the "
          f"CPU's and exact at 3 entries each (max |card - exact| {worst:.1e})", flush=True)
    return {"partials": n_parts, "worst": worst}


def tier_line(label: str, r) -> str:
    errs = " ".join(f"{k}={v:.2e}" for k, v in r.errs.items())
    return solve_line(label, r) + f" obj-dual={r.objective - r.dual_objective:.2e} {errs}"


def precision_tiers(launches, ltt, maxg11_f64) -> None:
    """Phases 18-21: the precision tiers end to end on the card, with the
    options of tests/test_precision.py (kept in `utils/profiling.py`)."""
    from loraine_tpu_torch.utils.profiling import (CASES, CG_DD, CG_DD2, DD, DD2, lp_synthetic,
                                                   tru3_sparse)

    tru3_dd2, lp_dd2 = CASES["tru3-sparse-dd2"][1], CASES["lp-dd2"][1]
    # ---- phase 18: theta1 'dd', card beside the port's CPU run
    ref = ltt.solve_sdpa(THETA1, DD, device="cpu")
    r = launches.run("phase 18", ("B1", "B2"), lambda: ltt.solve_sdpa(THETA1, DD, device="cuda"))
    print(tier_line("18 theta1 dd cuda", r) + f" | cpu: {ref.status_name} obj={ref.objective!r} "
          f"it={ref.iterations} dimacs={ref.dimacs:.3e}", flush=True)
    check(r.status == 1 and r.dimacs < DD["eDIMACS"], "theta1 dd not OPTIMAL at 1e-11")
    check(abs(r.objective - THETA1_OPT) < 1e-9, "theta1 dd objective")
    check(abs(r.objective - r.dual_objective) < 1e-9, "theta1 dd primal-dual gap")
    check(abs(r.iterations - ref.iterations) <= 1, "theta1 dd iterations vs CPU")

    # ---- phase 19: dd2 floors (theta1 dense, tru3 forced sparse, LP)
    r = launches.run("phase 19 (theta1 dd2)", ("B1", "B2"),
                     lambda: ltt.solve_sdpa(THETA1, DD2, device="cuda"))
    print(tier_line("19 theta1 dd2 cuda", r), flush=True)
    check(r.status == 1 and abs(r.objective - THETA1_OPT) < 1e-9, "theta1 dd2")
    check(r.errs["err1"] < 1e-18 and r.errs["err3"] < 1e-15, "theta1 dd2 residual floors")
    check(r.final_state.X_lo is not None, "theta1 dd2 without tails")
    p = tru3_sparse("cuda")
    check(all(g.is_sparse for g in p.groups), "tru3 not sparse")
    r = launches.run("phase 19 (tru3 sparse dd2)", ("B1", "B2"),
                     lambda: ltt.solve(p, tru3_dd2, device="cuda"))
    print(tier_line("19 tru3 sparse dd2 cuda", r), flush=True)
    check(r.status == 1 and abs(r.objective - 0.0625018) < 1e-5, "tru3 sparse dd2")
    check(r.errs["err1"] < 1e-18 and r.errs["err3"] < 1e-18, "tru3 sparse dd2 residual floors")
    p = lp_synthetic("cuda")
    r = launches.run("phase 19 (LP synthetic dd2)", ("B1", "B2"),
                     lambda: ltt.solve(p, lp_dd2, device="cuda"))
    print(tier_line("19 LP synthetic dd2 cuda", r), flush=True)
    check(r.status == 1 and r.dimacs < lp_dd2["eDIMACS"], "LP synthetic dd2 DIMACS")

    # ---- phase 20: theta1 on the CG path under dd and dd2: no CG kernel
    for prec, o in (("dd", CG_DD), ("dd2", CG_DD2)):
        r = launches.run(f"phase 20 (theta1 kit=1 {prec})", ("B1", "B2"),
                         lambda: ltt.solve_sdpa(THETA1, o, device="cuda"))
        print(tier_line(f"20 theta1-cg {prec} cuda", r), flush=True)
        check(r.status == 1 and r.dimacs < o["eDIMACS"], f"theta1 kit=1 {prec}")
        check(abs(r.objective - THETA1_OPT) <= 1e-8 * THETA1_OPT, f"theta1 kit=1 {prec} objective")
        ran = {k: sum(v.values()) for k, v in launches.by_regime.items() if k in CG_KERNELS}
        check(not any(ran.values()), f"theta1 kit=1 {prec}: a CG kernel ran {ran}")

    # ---- phase 21: maxG11 at full size in dd, beside phase 4's f64 run
    r, wall, peak = large_case(launches, "21", MAXG11, MAXG11_DD, (MAXG11_REF[0], None), ltt)
    r64, wall64, peak64 = maxg11_f64
    med, med64 = (1e3 * float(np.median(x.iteration_times)) for x in (r, r64))
    print(f"phase 21 maxG11 dd vs f64: it {r.iterations} vs {r64.iterations}, dimacs "
          f"{r.dimacs:.3e} vs {r64.dimacs:.3e}, wall {wall:.3f} vs {wall64:.3f} s, solve "
          f"{r.solve_time:.3f} vs {r64.solve_time:.3f} s, median_iter_ms {med:.2f} vs {med64:.2f} "
          f"(ratio {med / med64:.2f}), peak_mem_MiB {peak:.1f} vs {peak64:.1f}", flush=True)
    check(abs(r.objective - MAXG11_REF[0]) <= 1e-6 * MAXG11_REF[0], "maxG11 dd objective")


def jacobi_launched(launches) -> dict:
    """B1's and B2's launches in the solve just run."""
    return {k: sum(v.values()) for k, v in launches.by_mp.items()}


def check_jacobi(launches, label: str, b1: bool, b2: bool) -> None:
    """The solve just run launched B1 iff ``b1`` and B2 iff ``b2``."""
    got = jacobi_launched(launches)
    check((got["B1"] > 0) == b1 and (got["B2"] > 0) == b2,
          f"{label}: Jacobi launches {got}, expected B1 {b1} B2 {b2}")


def jax_cpu_modes(launches, ltt, maxg11_f64) -> None:
    """Phases 22-23: maxG11 and theta1 under the JAX CPU run's own modes."""
    # ---- phase 22: maxG11 under eigh_backend='mixed', step_eig='exact'
    r, _, _ = large_case(launches, "22 (mixed, exact)", MAXG11, MAXG11_JAX_CPU, MAXG11_REF, ltt,
                         needs=())
    check_jacobi(launches, "phase 22 (mixed, exact)", False, False)
    o = dict(MAXG11_JAX_CPU, step_eig="pallas")
    r2, _, _ = large_case(launches, "22 (mixed, pallas)", MAXG11, o, (MAXG11_REF[0], None), ltt,
                          needs=("B2",))
    check_jacobi(launches, "phase 22 (mixed, pallas)", False, True)
    r4 = maxg11_f64[0]
    med = " / ".join(f"{1e3 * float(np.median(x.iteration_times)):.2f}" for x in (r, r2, r4))
    print(f"phase 22 maxG11 iterations: seed library f32 eigh + exact eigenvalues (the JAX "
          f"CPU modes) {r.iterations} (JAX CPU {MAXG11_REF[1]}) | seed library f32 eigh + B2 "
          f"bounds {r2.iterations} | seed B1 + B2 bounds (phase 4) {r4.iterations}; "
          f"steplength mode moves {r2.iterations - r.iterations:+d}, seed moves "
          f"{r4.iterations - r2.iterations:+d}; median_iter_ms {med}", flush=True)

    # ---- phase 23: theta1 under 'jacobi'/'xla' + 'exact', card vs CPU
    for backend in ("jacobi", "xla"):
        o = dict(THETA1_K0, eigh_backend=backend, step_eig="exact")
        ref = ltt.solve_sdpa(THETA1, o, device="cpu")
        r = launches.run(f"phase 23 ({backend}, exact)", (),
                         lambda: ltt.solve_sdpa(THETA1, o, device="cuda"))
        print(solve_line(f"23 theta1 {backend}/exact cuda", r) + f" | cpu: {ref.status_name} "
              f"obj={ref.objective!r} it={ref.iterations} solve={ref.solve_time:.3f} s", flush=True)
        check_jacobi(launches, f"phase 23 ({backend})", False, False)
        check(r.status == ref.status == 1, f"theta1 {backend}/exact not OPTIMAL")
        check(r.iterations == ref.iterations, f"theta1 {backend}/exact iterations vs CPU")
        check(abs(r.objective - ref.objective) <= 1e-9, f"theta1 {backend}/exact objective vs CPU")


def steplength_modes(launches, ltt) -> None:
    """Phases 24-25: the other steplength modes, the SVD NT scaling and f32."""
    from loraine_tpu_torch.utils.profiling import THETA1_CG

    cases = [(THETA1, THETA1_K0, {"step_eig": "chol"}, THETA1_OPT),
             (THETA1, THETA1_K0, {"step_eig": "lanczos"}, THETA1_OPT),
             (CONTROL1, CONTROL1_K0, {"step_eig": "chol"}, CONTROL1_OPT),
             # the JAX package's CPU run ends at the iteration limit too
             (CONTROL1, CONTROL1_K0, {"step_eig": "lanczos", "maxit": 40}, None),
             (THETA1, THETA1_K0, {"nt_method": "svd", "eigh_backend": "xla"}, THETA1_OPT)]
    for path, base, extra, opt in cases:
        o = dict(base, **extra)
        svd = "nt_method" in extra
        label = f"phase 24 ({path.split('/')[-1]} {extra})"
        r = launches.run(label, ("B2",) if svd else ("B1",),
                         lambda: ltt.solve_sdpa(path, o, device="cuda"))
        print(solve_line(f"24 {path.split('/')[-1]} {extra} cuda", r), flush=True)
        check_jacobi(launches, label, not svd, svd)
        if opt is None:
            check(r.status == 4 and r.iterations == o["maxit"], f"{label}: not the JAX run's end")
            continue
        check(r.status == 1, f"{label} not OPTIMAL")
        check(abs(r.objective - opt) <= OBJ_RTOL * opt, f"{label} objective")

    # ---- phase 25: dtype='float32' end to end through B1 and B2
    r = launches.run("phase 25", ("B1", "B2"), lambda: ltt.solve_sdpa(THETA1, THETA1_F32,
                                                                       device="cuda"))
    print(solve_line("25 theta1 float32 cuda", r), flush=True)
    check(r.status in (1, 4), "theta1 float32 status")
    check(abs(r.objective - THETA1_OPT) <= 5e-2 * THETA1_OPT, "theta1 float32 objective")
    check(r.final_state.X[0].dtype == torch.float32, "theta1 float32 iterates not f32")
    # kit=1: B3 and the polish on f64 copies of the f32 operator
    o = dict(THETA1_CG, eDIMACS=5e-3, tol_cg_min=1e-4, dtype="float32", maxit=50)
    r = launches.run("phase 25 (kit=1)", KIT1_NEEDS, lambda: ltt.solve_sdpa(THETA1, o,
                                                                            device="cuda"))
    print(solve_line("25 theta1-cg float32 cuda", r), flush=True)
    check(r.status == 1 and abs(r.objective - THETA1_OPT) <= 1e-3 * THETA1_OPT,
          "theta1-cg float32")
    check(r.final_state.y.dtype == torch.float32, "theta1-cg float32 iterates not f32")


def assembly_modes(launches, ltt, f64_runs) -> None:
    """Phase 26: the f32 Schur assembly and its handover to f64."""
    cases = [("theta1", THETA1, dict(THETA1_K0, assembly_precision="f32"), True),
             ("tru3", "tests/data/tru3.dat-s", dict(LP_KIT0, assembly_precision="auto"), False),
             ("tru9", TRU9, dict(LARGE_KIT0, assembly_precision="auto"), True)]
    for name, path, o, engaged in cases:
        r64 = f64_runs[name]
        r = launches.run(f"phase 26 ({name} {o['assembly_precision']})", ("B1", "B2"),
                         lambda: ltt.solve_sdpa(path, o, device="cuda"))
        print(solve_line(f"26 {name} assembly_precision={o['assembly_precision']} cuda", r)
              + f" handover_after_iteration={r.mixed_handover} | f64: it={r64.iterations} "
              f"obj={r64.objective!r} solve={r64.solve_time:.3f} s", flush=True)
        check(r.status == 1, f"{name} assembly {o['assembly_precision']} not OPTIMAL")
        check(abs(r.iterations - r64.iterations) <= 2, f"{name} assembly iterations vs f64")
        check(abs(r.objective - r64.objective) <= 1e-5 * abs(r64.objective) + 1e-7,
              f"{name} assembly objective vs f64")
        check((r.mixed_handover is not None) == engaged, f"{name} handover {r.mixed_handover}")


def eigen_routines() -> None:
    """Phase 27: ms and device launches per call of the eigen routines of
    the modes, beside the B1 and B2 wrappers, on clustered (IPM-like)
    spectra. Launches of `eigh_jacobi` at m = 800 (~10^5 a sweep) come from
    traces of 1 and 2 sweeps (fixed + sweeps x per sweep)."""
    from loraine_tpu_torch.ops import eigh as te, jacobi as tj, linalg as tl
    from loraine_tpu_torch.utils.profiling import device_rows

    def launched(fn) -> int:
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(r[2] for r in device_rows(prof))

    for nb, m in MODE_SHAPES:
        A = torch.from_numpy(spectrum_matrix("clustered", m, nb, seed=27 * m)).cuda()
        routines = {
            "eigh_jacobi": lambda: te.eigh_jacobi(A),
            "eigh_mixed(xla32)": lambda: te.eigh_mixed(A),
            "eigh_mixed(pallas)": lambda: te.eigh_mixed(A, seed="pallas"),
            "torch.linalg.eigh f64": lambda: torch.linalg.eigh(A),
            "eigmin_lanczos": lambda: te.eigmin_lanczos(A),
            "eigmin_chol": lambda: tl.eigmin_chol(A),
            "B1 eigh_jacobi_f32": lambda: tj.eigh_jacobi_f32(A),
            "B2 eig_bounds_jacobi": lambda: tj.eig_bounds_jacobi(A),
        }
        sweeps = te._default_sweeps(m)
        for name, fn in routines.items():
            if name == "eigh_jacobi" and m > 100:
                # seconds a call: the traces of 1 and 2 sweeps warm it, then
                # one call is timed
                one = launched(lambda: te.eigh_jacobi(A, sweeps=1))
                per_sweep = launched(lambda: te.eigh_jacobi(A, sweeps=2)) - one
                n = one + (sweeps - 1) * per_sweep
                how = f" ({per_sweep} a sweep x {sweeps} sweeps, from 1- and 2-sweep traces)"
                ms = cuda_ms(fn, 1, warmup=False)
            else:
                ms, n, how = cuda_ms(fn, 5), launched(fn), ""
            print(f"phase 27 (nb, m)=({nb}, {m}) {name}: ms={ms:.3f} launches={n}{how}",
                  flush=True)
            check(n > 0 and ms > 0, f"phase 27 {name} at ({nb}, {m})")


def sdpa_dict(path: str) -> dict:
    """The raw problem dict of an SDPA file (the stored matrices are SDPA's F
    matrices), built as tests/test_poema_io.py's `_dict_from_sdpa` does."""
    from loraine_tpu_torch.io.sdpa import read_sdpa

    data = read_sdpa(path)
    n = data.nvar
    A, C, msizes, lin = [], [], [], []
    for bs, (mat, row, col, val) in zip(data.block_sizes, data.blocks):
        if bs < 0:
            Cl, dl, f0 = np.zeros((n, -bs)), np.zeros(-bs), mat == 0
            np.add.at(dl, row[f0], val[f0])
            np.add.at(Cl, (mat[~f0] - 1, row[~f0]), val[~f0])
            lin.append((Cl, dl))
            continue
        stack, off = np.zeros((n + 1, bs, bs)), row != col
        np.add.at(stack, (mat, row, col), val)
        np.add.at(stack, (mat[off], col[off], row[off]), val[off])
        msizes.append(bs)
        C.append(stack[0])
        A.append(stack[1:])
    d = {"nvar": n, "nlmi": len(A), "msizes": np.asarray(msizes), "c": data.c, "A": A,
         "C": C, "b_const": 0.0, "nlin": 0}
    if lin:
        d["nlin"] = sum(dl.shape[0] for _, dl in lin)
        d["C_lin"] = np.concatenate([Cl for Cl, _ in lin], axis=1)
        d["d"] = np.concatenate([dl for _, dl in lin])
    return d


def json_entry(launches, ltt, f64_runs) -> None:
    """Phase 28: tru9 and vib9 through POEMA-JSON and `solve_json`."""
    with tempfile.TemporaryDirectory() as tmp:
        for name, path in (("tru9", TRU9), ("vib9", VIB9)):
            js = os.path.join(tmp, f"{name}.json")
            t0 = time.perf_counter()
            ltt.write_poema_json(js, sdpa_dict(path))
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            r = launches.run(f"phase 28 ({name} solve_json)", ("B1", "B2"),
                             lambda: ltt.solve_json(js, LARGE_KIT0, device="cuda"))
            wall = time.perf_counter() - t0
            ref = f64_runs[name]
            print(solve_line(f"28 {name} solve_json cuda", r)
                  + f" json_MB={os.path.getsize(js) / 1e6:.2f} write_s={t_write:.3f} "
                  f"load_s(read_poema_json+problem_from_dict)={wall - r.solve_time:.3f} "
                  f"| .dat-s solve (phase {11 if name == 'tru9' else 12}): "
                  f"obj={ref.objective!r} it={ref.iterations} solve={ref.solve_time:.3f} s",
                  flush=True)
            check(r.status == 1, f"{name} solve_json not OPTIMAL")
            check(abs(r.objective - ref.objective) <= OBJ_RTOL * abs(ref.objective),
                  f"{name} solve_json objective vs the .dat-s solve")
            check(abs(r.iterations - ref.iterations) <= 2, f"{name} solve_json iterations")
            check(math.isfinite(r.dimacs) and r.dimacs < LARGE_KIT0["eDIMACS"],
                  f"{name} solve_json DIMACS")


def maxg11_graph() -> np.ndarray:
    """maxG11's graph from its C block: F_0 = L/4 with L = diag(W 1) - W, so
    W_ij = -4 F_0[i,j] off the diagonal (maxcut_problem's F_0 for this W is
    maxG11's)."""
    from loraine_tpu_torch.io.sdpa import read_sdpa

    data = read_sdpa(MAXG11)
    mat, row, col, val = data.blocks[0]
    f0 = (mat == 0) & (row != col)
    W = np.zeros((data.nvar, data.nvar))
    W[row[f0], col[f0]] = -4.0 * val[f0]
    W = W + W.T
    deg = np.zeros(data.nvar)
    np.add.at(deg, row[(mat == 0) & (row == col)], 4.0 * val[(mat == 0) & (row == col)])
    check(np.array_equal(deg, W.sum(1)), "maxG11: F_0's diagonal is not L/4's")
    return W


def models_phase(launches, ltt) -> None:
    """Phase 29: the model families and the modeling layer on the card."""
    from loraine_tpu_torch import models
    from loraine_tpu_torch.modeling import Model, dot
    from loraine_tpu_torch.problem import pick_storage

    W = maxg11_graph()
    o = {"eDIMACS": MAXG11_OPTS["eDIMACS"], "initpoint": 1}
    S, T, val = launches.run("phase 29 (solve_maxcut maxG11)", ("B1", "B2"),
                             lambda: models.solve_maxcut(W, o, device="cuda"))
    cut = float(W[np.ix_(S, T)].sum())
    # maxcut_problem's storage: the modeled-cost rule at n = m = 800, s = 1
    storage = pick_storage(W.shape[0], [(W.shape[0], 1)])
    print(f"phase 29 solve_maxcut maxG11 graph ({W.shape[0]} nodes, {int((W != 0).sum()) // 2} "
          f"edges, storage {storage}): relaxation={val!r} (SDPLIB {MAXG11_OPT}) "
          f"rounded cut weight={cut} |S|={len(S)} |T|={len(T)}", flush=True)
    check(abs(val - MAXG11_OPT) <= OBJ_RTOL * MAXG11_OPT, "solve_maxcut maxG11 relaxation")
    check(0 < cut <= val, "solve_maxcut maxG11 cut weight")

    rng = np.random.default_rng(29)
    N = 200
    W2 = np.triu(rng.random((N, N)) < 0.05, 1) * rng.integers(1, 10, (N, N))
    W2 = (W2 + W2.T).astype(float)
    L = np.diag(W2.sum(1)) - W2
    m = Model()
    X = m.psd_var(N)
    for i in range(N):
        m.add_constraint(X[i, i] == 1)
    m.maximize(0.25 * dot(L, X))
    o2 = {"eDIMACS": 1e-7, "initpoint": 1}
    t0 = time.perf_counter()
    res = launches.run("phase 29 (Model.solve max-cut N=200)", ("B1", "B2"),
                       lambda: m.solve(o2, device="cuda"))
    t_model = time.perf_counter() - t0
    _, _, ref = models.solve_maxcut(W2, o2, device="cuda")
    print(f"phase 29 Model.solve max-cut N={N}: {res.status_name} obj={res.objective!r} "
          f"it={res.raw.iterations} wall(lower+solve)={t_model:.3f} s | solve_maxcut: {ref!r}",
          flush=True)
    check(res.status == 1, "Model.solve max-cut not OPTIMAL")
    check(abs(res.objective - ref) <= OBJ_RTOL * abs(ref), "Model.solve vs solve_maxcut")
    check(np.abs(np.diag(res.value(X)) - 1.0).max() < 1e-6, "Model.solve diag(X) = 1")

    lo, hi = launches.run("phase 29 (correlation_bounds)", ("B1", "B2"),
                          lambda: models.correlation_bounds(device="cuda"))
    print(f"phase 29 correlation_bounds: lower={lo!r} upper={hi!r} (ex_corr.jl {CORR_REF})",
          flush=True)
    check(abs(lo - CORR_REF[0]) <= 1e-6 * abs(CORR_REF[0]), "correlation lower bound")
    check(abs(hi - CORR_REF[1]) <= 1e-6 * abs(CORR_REF[1]), "correlation upper bound")

    p = models.lp_problem(np.array([2.0]), np.array([[-1.0, 1.0]]), np.array([-1.0, 2.0]),
                          device="cuda")
    r = launches.run("phase 29 (lp_problem, no LMI block)", (),
                     lambda: ltt.solve(p, {"kit": 0, "eDIMACS": 1e-8, "verb": 0}, device="cuda"))
    print(solve_line("29 lp_problem (k.jl) cuda", r) + f" X_lin={r.X_lin.tolist()}", flush=True)
    check_jacobi(launches, "phase 29 (lp_problem)", False, False)
    check(r.status == 1 and abs(-r.objective - 4.0) <= 1e-6 * 4.0, "lp_problem objective")
    check(np.abs(r.X_lin - [0.0, 2.0]).max() < 1e-6, "lp_problem shadow prices")


def admm_phase(launches, ltt, theta1_f64) -> None:
    """Phase 30: ADMM on theta1, then the IPM warm-started from it."""
    p = ltt.load_problem(THETA1, THETA1_K0, device="cuda")
    a = launches.run("phase 30 (solve_admm theta1)", (),
                     lambda: ltt.solve_admm(p, eps=1e-5, maxiter=20000, verb=0))
    check_jacobi(launches, "phase 30 (ADMM: library eigh)", False, False)
    # the host reading err after every iteration (chunk=1) against once a
    # chunk of 100 (the default): the same iterates, the cost of the reads
    a1 = ltt.solve_admm(p, eps=1e-5, maxiter=20000, verb=0, chunk=1)
    print(f"phase 30 solve_admm theta1 eps=1e-5 cuda: {a.status_name} obj={a.objective!r} "
          f"it={a.iterations} err={a.err:.3e} solve={a.solve_time:.3f} s "
          f"ms_per_iteration={1e3 * a.solve_time / a.iterations:.4f} (err read once a chunk "
          f"of 100) | chunk=1: it={a1.iterations} solve={a1.solve_time:.3f} s "
          f"ms_per_iteration={1e3 * a1.solve_time / a1.iterations:.4f}", flush=True)
    check(a.status == 1 and abs(a.objective - THETA1_OPT) <= 1e-4 * THETA1_OPT, "ADMM theta1")
    check(a1.iterations == a.iterations
          and abs(a1.objective - a.objective) <= 1e-12 * THETA1_OPT,
          "ADMM result independent of the chunk")
    check(np.linalg.eigvalsh(a.S[0]).min() > -1e-9, "ADMM S not PSD")

    # tests/test_admm.py::test_admm_warm_starts_ipm on the card
    w = ltt.solve_admm(p, eps=1e-3, maxiter=5000, verb=0)
    (g,) = p.groups
    m0 = w.X[0].shape[0]
    pad = np.r_[np.zeros(m0), np.ones(g.m - m0)]

    def block(M, tail):
        return torch.from_numpy((np.pad(M, ((0, g.m - m0),) * 2) + np.diag(pad * tail)
                                 + 1e-2 * np.eye(g.m))[None]).cuda()

    st = ltt.IPMState(X=(block(w.X[0], 0.1),), S=(block(w.S[0], 1.0),),
                      y=torch.from_numpy(w.y).cuda(), X_lin=None, S_lin=None,
                      sigma=torch.tensor(3.0, dtype=torch.float64, device="cuda"))
    r = launches.run("phase 30 (IPM warm-started from ADMM)", ("B1", "B2"),
                     lambda: ltt.Solver(p, {"eDIMACS": 1e-6, "verb": 0}, initial_state=st,
                                        device="cuda").solve())
    print(solve_line("30 theta1 IPM from the ADMM iterate (eps 1e-3, "
                     f"{w.iterations} ADMM iterations) cuda", r)
          + f" | cold start (phase 3): it={theta1_f64.iterations}", flush=True)
    check(r.status == 1 and abs(r.objective - THETA1_OPT) <= 1e-6 * THETA1_OPT,
          "IPM warm-started from ADMM")


def checkpoint_phase(launches, ltt, maxg11_f64):
    """Phase 31: maxG11 checkpointed after 5 iterations and resumed. Returns
    the problem."""
    r4 = maxg11_f64[0]
    p = ltt.load_problem(MAXG11, MAXG11_OPTS, device="cuda")
    part = launches.run("phase 31 (maxG11 maxit=5)", ("B1", "B2"),
                        lambda: ltt.solve(p, dict(MAXG11_OPTS, maxit=5), device="cuda"))
    check(part.status == 4 and part.iterations == 5, "maxG11 maxit=5")
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "maxG11.npz")
        ltt.save_state(ck, part.final_state)
        size = os.path.getsize(ck)
        state = ltt.load_state(ck, device="cuda")
    check(all(torch.equal(a, b) for a, b in zip(state.X + state.S, part.final_state.X
                                                + part.final_state.S)), "load_state != saved")
    r = launches.run("phase 31 (maxG11 resumed)", ("B1", "B2"),
                     lambda: ltt.Solver(p, MAXG11_OPTS, initial_state=state,
                                        device="cuda").solve())
    print(solve_line("31 maxG11 resumed from a 5-iteration checkpoint cuda", r)
          + f" checkpoint_MB={size / 1e6:.2f} | 5 + {r.iterations} = {5 + r.iterations} vs "
          f"phase 4 it={r4.iterations} obj={r4.objective!r}", flush=True)
    check(r.status == 1, "maxG11 resume not OPTIMAL")
    check(abs(r.objective - r4.objective) <= 1e-6 * abs(r4.objective), "maxG11 resume objective")
    check(abs(5 + r.iterations - r4.iterations) <= 3, "maxG11 resume iterations")
    return p


@contextlib.contextmanager
def launches_in_profile_phases(tj, tp):
    """Counts the B1, B2 and B3 launches made inside `profile_phases` (the
    solver's timing=2 pass) into the yielded dict."""
    import loraine_tpu_torch.utils.diagnostics as diag

    def counts():
        return {"B1": sum(tj.jacobi_eigh_cuda.launches_by_mp.values()),
                "B2": sum(tj.jacobi_bounds_cuda.launches_by_mp.values()),
                "B3": tp.cg_minres_f64_cuda.launches}

    inside = dict.fromkeys(("B1", "B2", "B3"), 0)
    orig = diag.profile_phases

    def wrapped(*a, **kw):
        before = counts()
        out = orig(*a, **kw)
        after = counts()
        for k in inside:
            inside[k] += after[k] - before[k]
        return out

    diag.profile_phases = wrapped
    try:
        yield inside
    finally:
        diag.profile_phases = orig


def diagnostics_phase(launches, ltt, tj, tp, maxg11_f64, p_maxg11, card) -> None:
    """Phase 32: timing=2, profile_dir and the flop model's utilization."""
    from loraine_tpu_torch.utils import flops
    from loraine_tpu_torch.utils.profiling import CONTROL1_CG

    for label, path, o, needs in (("theta1 kit=0", THETA1, THETA1_K0, ("B2",)),
                                  ("control1-cg kit=1", CONTROL1, CONTROL1_CG, ("B2", "B3"))):
        with launches_in_profile_phases(tj, tp) as inside:
            r = launches.run(f"phase 32 ({label} timing=2)", ("B1", "B2"),
                             lambda: ltt.solve_sdpa(path, dict(o, timing=2, verb=1),
                                                    device="cuda"))
        print(f"phase 32 {label} timing=2: {r.status_name} it={r.iterations}; launches inside "
              f"profile_phases: {inside}", flush=True)
        check(r.status == 1, f"{label} timing=2 not OPTIMAL")
        check(all(inside[k] > 0 for k in needs), f"{label}: {needs} not launched in "
                                                  f"profile_phases ({inside})")
    with tempfile.TemporaryDirectory() as tmp:
        r = launches.run("phase 32 (theta1 profile_dir)", ("B1", "B2"),
                         lambda: ltt.solve_sdpa(THETA1, dict(THETA1_K0, profile_dir=tmp),
                                                device="cuda"))
        traces = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        check(len(traces) == 1 and os.path.getsize(traces[0]) > 0, f"profile_dir: {traces}")
        size = os.path.getsize(traces[0])
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {k: sum(k in n for n in kernels) for k in JACOBI_GLOBALS}
    jac = jacobi_launched(launches)
    print(f"phase 32 profile_dir theta1: {r.status_name} trace {size / 1e6:.2f} MB, "
          f"{len(kernels)} device kernels, csrc/jacobi.cu kernels by name {named} "
          f"(wrapper launches B1 {jac['B1']} B2 {jac['B2']}, regime {launches.by_regime['B1']})",
          flush=True)
    check(named["sm_kernel"] == jac["B1"] + jac["B2"] > 0,
          "profile_dir trace does not name one sm_kernel per B1/B2 launch")
    r4 = maxg11_f64[0]
    fl = flops.iteration_flops(p_maxg11, 0)
    sec = float(np.median(r4.iteration_times))
    u = flops.utilization(fl["total"], sec)
    print(f"phase 32 maxG11 (phase 4) median iteration {1e3 * sec:.2f} ms, model flops "
          + " ".join(f"{k}={v:.4g}" for k, v in fl.items())
          + f": {fl['total'] / sec / 1e12:.3f} TFLOP/s = utilization {u:.4f} of the H100's "
          f"f64 peak {flops.H100_F64_PEAK_FLOPS / 1e12:.0f} TFLOP/s (data sheet, 700 W) on "
          f"'{card}'", flush=True)
    check(0 < u < 1, "maxG11 utilization")


def cli_phase() -> None:
    """Phase 33: the CLI in a subprocess on the card."""
    cmd = [sys.executable, "-m", "loraine_tpu_torch", "solve", THETA1, "--kit", "0",
           "--eDIMACS", "1e-6", "--initpoint", "1", "--json"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"CLI rc {out.returncode}: {out.stderr[-2000:]}")
    payload = json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1])
    print(f"phase 33 CLI `{' '.join(cmd[1:])}`: rc={out.returncode} {payload} "
          f"process_wall={wall:.3f} s", flush=True)
    check(payload["status"] == "OPTIMAL", "CLI not OPTIMAL")
    check(abs(payload["objective"] - THETA1_OPT) <= 1e-6 * THETA1_OPT, "CLI objective")


def mesh_phases(f64_runs, maxg11_f64, card: str) -> None:
    """Phases 34-36: the mesh through `parallel/dryrun.py`, every rank a
    process of its own on the card. A failed rank or gate fails the
    launch, and so the phase."""
    from loraine_tpu_torch.parallel import dryrun
    from loraine_tpu_torch.parallel.distributed import launch

    def run(phase, nproc, backend, extra, timeout):
        cmd = ["-m", "loraine_tpu_torch.parallel.dryrun", "--device", "cuda",
               "--backend", backend, *extra]
        t0 = time.perf_counter()
        outs = launch(cmd, nproc, timeout=timeout)
        wall = time.perf_counter() - t0
        recs = dryrun.records(outs)
        coll = [ln for out in outs for ln in out.splitlines() if ln.startswith("COLLECTIVES")]
        check(len(coll) == nproc and all("device=cuda" in ln for ln in coll),
              f"phase {phase}: all_reduce/broadcast on CUDA tensors not confirmed: {coll}")
        if phase == 34:
            print(f"phase 34 {nproc} rank(s) {backend}: {coll[0]}", flush=True)
        for line in dryrun.summarize(recs):
            print(f"phase {phase} {nproc} rank(s) {backend}: {line}", flush=True)
        print(f"phase {phase} {nproc} rank(s) {backend}: wall {wall:.1f} s (launch and "
              f"process start included) on '{card}'", flush=True)
        for r in recs:
            check(r["launches"][0] > 0 and r["launches"][1] > 0,
                  f"phase {phase}: rank {r['rank']} launched B1/B2 {r['launches']} "
                  f"in {r.get('case') or 'gate %d' % r['gate']}")
        return recs

    # ---- phase 34: the seven gates at 1 (NCCL), 2 and 4 ranks (Gloo)
    for nproc, backend in ((1, "nccl"), (2, "gloo"), (4, "gloo")):
        recs = run(34, nproc, backend, [], 600)
        check(sorted((r["rank"], r["gate"]) for r in recs)
              == [(k, g) for k in range(nproc) for g in range(1, 8)],
              f"phase 34: gates missing at {nproc} ranks")
        for r in recs:
            check(r["rel"] <= dryrun.TOLS[r["gate"]], f"phase 34 gate {r['gate']} tolerance")
            if r["gate"] == 2:  # the kit=1 gate: B3 on every mesh
                check(r["launches"][2] > 0,
                      f"phase 34 gate 2 on {r['mesh']}: B3 launches {r['launches'][2]}")
        for g in range(1, 8):
            secs = [round(r["seconds"], 3) for r in recs if r["gate"] == g]
            print(f"phase 34 {nproc} rank(s) gate {g}: sharded run per rank {secs} s "
                  f"on '{card}'", flush=True)

    # ---- phase 35: maxG11 and tru9 on the (1, 2) mesh, one maxG11 step on (1, 4)
    for name, opts, ref in (("maxG11", MAXG11_OPTS, maxg11_f64[0]),
                            ("tru9", LARGE_KIT0, f64_runs["tru9"])):
        recs = run(35, 2, "gloo", ["--case", f"sdplib:{name}", "--opts", json.dumps(opts)], 600)
        for r in recs:
            check(r["status"] == 1, f"phase 35 {name} rank {r['rank']} not OPTIMAL")
            check(abs(r["sharded"] - ref.objective) <= 1e-7 * abs(ref.objective),
                  f"phase 35 {name}: sharded {r['sharded']!r} != single card {ref.objective!r}")
        print(f"phase 35 {name} (1, 2): obj {recs[0]['sharded']!r} it {recs[0]['iters'][0]} "
              f"sharded {recs[0]['seconds']:.3f} s median_iter {recs[0]['median_iter_s']:.4f} s | "
              f"single card: obj {ref.objective!r} it {ref.iterations} {ref.solve_time:.3f} s "
              f"median_iter {float(np.median(ref.iteration_times)):.4f} s; on '{card}'",
              flush=True)
    run(35, 4, "gloo", ["--case", "sdplib:maxG11", "--step", "--opts", json.dumps(MAXG11_OPTS)],
        600)

    # ---- phase 36: the 2-process initialize() solve through Gloo
    recs = run(36, 2, "gloo", ["--case", "two_process"], 300)
    check(all(r["status"] == 1 for r in recs), "phase 36 not OPTIMAL")
    objs = [r["sharded"] for r in recs]
    check(abs(objs[0] - objs[1]) <= 1e-12 * abs(objs[0]), f"phase 36 objectives {objs}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    # full-f32 matmuls (TF32 keeps ~3 digits); the package checks the first
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    import loraine_tpu_torch as ltt
    import loraine_tpu_torch.ipm.step as S
    from loraine_tpu_torch.ops import jacobi as tj, pcg as tp
    from loraine_tpu_torch.utils.cuda_build import BUILD_DIR, build_libraries
    from loraine_tpu_torch.utils.profiling import CONTROL1_CG, THETA1_CG, theta_g100

    # ---- phase 1: setup + build
    print(f"phase 1 python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card '{card}' count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    build_libraries("jacobi", "pcg")
    tj._lib()
    tp._lib()
    print(f"phase 1 built+loaded csrc/jacobi.cu and csrc/pcg.cu in "
          f"{time.perf_counter() - t0:.2f} s into {BUILD_DIR}", flush=True)

    # ---- phase 2: Jacobi kernels vs plain versions on the card
    k = kernels_vs_plain(tj)
    launches = Launches(tj, tp)

    # ---- phase 3: theta1, card against the port's CPU run
    opts = THETA1_K0
    ref = ltt.solve_sdpa(THETA1, opts, device="cpu")
    r = launches.run("phase 3", ("B1", "B2"), lambda: ltt.solve_sdpa(THETA1, opts, device="cuda"))
    f64_runs = {"theta1": r}
    print(f"phase 3 theta1 cuda: {r.status_name} obj={r.objective!r} it={r.iterations} "
          f"wall={r.solve_time:.3f} s it/s={r.iterations / r.solve_time:.2f} "
          f"median_iter_ms={1e3 * float(np.median(r.iteration_times)):.2f} dimacs={r.dimacs:.3e} | "
          f"cpu: {ref.status_name} obj={ref.objective!r} it={ref.iterations}", flush=True)
    check(r.status == 1, "theta1 not OPTIMAL")
    check(abs(r.objective - THETA1_OPT) <= OBJ_RTOL * THETA1_OPT, "theta1 objective")
    # same algorithm, kernels vs plain versions: same iterations, objective
    # within 1e-7 relative (f32 seed rounding under the f64 refinement)
    check(r.iterations == ref.iterations, "theta1 iterations differ from the CPU run")
    check(abs(r.objective - ref.objective) <= 1e-7 * abs(ref.objective), "theta1 vs CPU run")

    # ---- phase 4: maxG11 at full size, against the JAX package's CPU run
    r, wall, peak = large_case(launches, "4", MAXG11, MAXG11_OPTS, MAXG11_REF, ltt)
    check(r.X[0].shape == (800, 800), "maxG11 primal block")
    maxg11_f64 = (r, wall, peak)

    # ---- phase 5: the kit=0 path went through both Jacobi kernels
    print(f"phase 5 launches in phases 3-4: B1={launches.total['B1']} "
          f"B2={launches.total['B2']}", flush=True)

    # ---- phase 6: CG kernels vs plain versions on the card
    kc = pcg_vs_plain(tp)
    kc["times"] = pcg_times(tp)

    # ---- phase 7: control1 on the CG path, card beside the port's CPU run
    ref = ltt.solve_sdpa(CONTROL1, CONTROL1_CG, device="cpu")
    r = launches.run("phase 7", KIT1_NEEDS,
                     lambda: ltt.solve_sdpa(CONTROL1, CONTROL1_CG, device="cuda"))
    print(solve_line("7 control1-cg cuda", r) + f" | cpu: {ref.status_name} "
          f"obj={ref.objective!r} it={ref.iterations} cg_it={ref.cg_iterations}", flush=True)
    check_b3_regime(launches, "phase 7", "block")
    check(r.status == 1, "control1-cg not OPTIMAL")
    check(abs(r.objective - CONTROL1_OPT) <= OBJ_RTOL * CONTROL1_OPT, "control1-cg objective")
    check(r.dimacs < CONTROL1_CG["eDIMACS"], "control1-cg DIMACS")

    # ---- phase 8: theta1 on the CG path, materialized and matrix-free
    for route, extra, needs in (("materialized", {}, KIT1_NEEDS),
                                ("matrix-free", {"cg_materialize": "never"}, ("B1", "B2"))):
        o = dict(THETA1_CG, **extra)
        r = launches.run(f"phase 8 ({route})", needs,
                         lambda: ltt.solve_sdpa(THETA1, o, device="cuda"))
        print(solve_line(f"8 theta1-cg {route} cuda", r), flush=True)
        if route == "materialized":
            check_b3_regime(launches, "phase 8", "block")
        check(r.status == 1, f"theta1-cg {route} not OPTIMAL")
        check(abs(r.objective - THETA1_OPT) <= OBJ_RTOL * THETA1_OPT, f"theta1-cg {route} objective")

    # ---- phase 9: theta_G100 at full size, kit=1 against kit=0
    p = theta_g100("cuda")
    res = {}
    for kit, o, needs in ((1, THETA1_CG, KIT1_NEEDS),
                          (0, {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0}, ("B1", "B2"))):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with cg_iteration_log(S) as log:
            r = launches.run(f"phase 9 (kit={kit})", needs, lambda: ltt.solve(p, o, device="cuda"))
        wall = time.perf_counter() - t0
        print(solve_line(f"9 theta_G100 n={p.n} kit={kit} cuda", r) + f" wall={wall:.3f} s "
              f"peak_mem_MiB={torch.cuda.max_memory_allocated() / 2**20:.1f}", flush=True)
        if kit == 1:
            # two solves (predictor, corrector) an IPM iteration
            per_it = {k_: [int(a) + int(b_) for a, b_ in zip(v[::2], v[1::2])]
                      for k_, v in log.items()}
            print(f"phase 9 kit=1 CG iterations per IPM iteration: B3 {per_it['pcg_kernel_ff']} "
                  f"polish {per_it['_polish']}", flush=True)
            check_b3_regime(launches, "phase 9", "cluster")
        check(r.status == 1, f"theta_G100 kit={kit} not OPTIMAL")
        check(r.X[0].shape == (100, 100) and bool(np.isfinite(r.X[0]).all()), "theta_G100 primal block")
        res[kit] = r.objective
    check(abs(res[1] - res[0]) <= OBJ_RTOL * abs(res[0]), "theta_G100 kit=1 vs kit=0 objective")

    # ---- phase 10: the f32 CG kernel end to end
    r = launches.run("phase 10", ("B1", "B2", "B4", "polish"),
                     lambda: ltt.solve_sdpa(CONTROL1, CONTROL1_F32, device="cuda"))
    print(solve_line("10 control1 cg_kernel=pallas cuda", r), flush=True)
    check(r.status == 1, "control1 with the f32 CG kernel not OPTIMAL")
    check(abs(r.objective - 17.7846) <= 1e-3 * 17.7846, "control1 f32 CG objective")

    # ---- phase 11: tru9 at full size (sparse storage, LP cone)
    f64_runs["tru9"] = large_case(launches, "11", TRU9, LARGE_KIT0, TRU9_REF, ltt)[0]

    # ---- phase 12: vib9 at full size, two block groups
    p = ltt.load_problem(VIB9, LARGE_KIT0, device="cuda")
    groups = [(g.m, g.nb, g.is_sparse) for g in p.groups]
    print(f"phase 12 vib9 groups (m, nb, sparse): {groups} nlin={p.nlin}", flush=True)
    check(groups == [(144, 1, True), (152, 1, True)] and p.nlin == 6480, "vib9 block groups")
    f64_runs["vib9"] = large_case(launches, "12", VIB9, LARGE_KIT0, VIB9_REF, ltt, problem=p)[0]
    for kname in ("B1", "B2"):
        check(all(launches.by_mp[kname].get(mp, 0) > 0 for mp in (144, 160)),
              f"vib9: {kname} not launched at both mp 144 and 160")

    # ---- phase 13: tru3 and vib3 (LP cone), kit=0 and kit=1, card vs CPU
    for name in ("tru3", "vib3"):
        path = f"tests/data/{name}.dat-s"
        for kit, o, needs in ((0, LP_KIT0, ("B1", "B2")), (1, CONTROL1_CG, KIT1_NEEDS)):
            ref = ltt.solve_sdpa(path, o, device="cpu")
            r = launches.run(f"phase 13 ({name} kit={kit})", needs,
                             lambda: ltt.solve_sdpa(path, o, device="cuda"))
            print(solve_line(f"13 {name} kit={kit} cuda", r) + f" | cpu: {ref.status_name} "
                  f"obj={ref.objective!r} it={ref.iterations} cg_it={ref.cg_iterations}", flush=True)
            check(r.status == ref.status == 1, f"{name} kit={kit} not OPTIMAL")
            check(abs(r.iterations - ref.iterations) <= 1, f"{name} kit={kit} iterations vs CPU")
            check(abs(r.objective - ref.objective) <= o["eDIMACS"] * abs(ref.objective),
                  f"{name} kit={kit} objective vs CPU")
            check(r.X_lin.shape == (72,) and bool((r.X_lin > 0).all()), f"{name} LP variables")
            if kit == 0:
                f64_runs[name] = r
            if kit == 1:
                check_b3_regime(launches, f"phase 13 ({name})", "block")

    # ---- phase 14: the sparse contractions are bitwise reproducible
    sparse_determinism(ltt)

    # ---- phase 15: thetaG11 at full size (rank-1, mp=816)
    large_case(launches, "15", THETAG11, THETAG11_OPTS, THETAG11_REF, ltt)
    check(launches.by_mp["B1"].get(816, 0) > 0, "thetaG11: B1 not launched at mp 816")

    # ---- phase 16: the solves went through all five kernels
    print("phase 16 launches in the solve phases: "
          + " ".join(f"{k_}={v}" for k_, v in launches.total.items()), flush=True)
    check(all(v > 0 for v in launches.total.values()), "a kernel was not launched")

    # ---- phases 17-21: the precision tiers
    exactness_probe()
    precision_tiers(launches, ltt, maxg11_f64)

    # ---- phases 22-27: the remaining eigen, steplength, NT, dtype and
    # assembly modes
    jax_cpu_modes(launches, ltt, maxg11_f64)
    steplength_modes(launches, ltt)
    assembly_modes(launches, ltt, f64_runs)
    eigen_routines()

    # ---- phases 28-33: the front-ends and extras, through B1, B2 and B3
    t0 = time.perf_counter()
    json_entry(launches, ltt, f64_runs)
    models_phase(launches, ltt)
    admm_phase(launches, ltt, f64_runs["theta1"])
    p_maxg11 = checkpoint_phase(launches, ltt, maxg11_f64)
    diagnostics_phase(launches, ltt, tj, tp, maxg11_f64, p_maxg11, card)
    cli_phase()
    print(f"phases 28-33 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phases 34-36: the mesh, each rank a process on this card
    t0 = time.perf_counter()
    mesh_phases(f64_runs, maxg11_f64, card)
    print(f"phases 34-36 took {time.perf_counter() - t0:.1f} s", flush=True)

    rows = []
    for key, kname, name, src, line in (
            ("eigh", "B1", "jacobi_eigh_f32", "jacobi", "jacobi_pallas.py:109"),
            ("bounds", "B2", "jacobi_bounds_f32", "jacobi", "jacobi_pallas.py:185")):
        ms, plain_ms, lib_ms, bnd, bound_by, regime = k["times"][key]
        rows.append({
            "name": name, "route": "cuda", "source": f"loraine_tpu_torch/csrc/{src}.cu",
            "replaces": f"loraine_tpu/ops/{line}",
            "launches": launches.total[kname], "max_abs_err": k["err"][key],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": bound_by,
            "library_ms": lib_ms, "regime": regime,
        })
    for kname, name, replaces in (
            ("B3", "cg_minres_f64", "loraine_tpu/ops/pcg_pallas.py:327"),
            ("B4", "cg_f32", "loraine_tpu/ops/pcg_pallas.py:48"),
            ("polish", "cg_f64", "loraine_tpu/ipm/step.py:832")):
        t = kc["times"][kname]  # n = 464
        rows.append({
            "name": name, "route": "cuda", "source": "loraine_tpu_torch/csrc/pcg.cu",
            "replaces": replaces, "launches": launches.total[kname],
            "max_abs_err": kc["err"][kname], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "n": 464, "regime": t["regime"], "regime_ms": t["regime_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
