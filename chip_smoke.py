#!/usr/bin/env python3
"""Smoke test of loraine_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and no network, and exits non-zero on the first failed check.

Phases:
  1. setup: card name and power limit, build of the CUDA kernels
     (csrc/jacobi.cu, csrc/pcg.cu, csrc/int8gemm.cu and csrc/dd_linalg.cu,
     one nvcc each for sm_90a, started together) from the checkout.
  2. each Jacobi kernel against its plain PyTorch version on the card, at
     the solver's shapes (nb, m) in {(1, 16), (2, 16), (1, 56), (2, 56),
     (1, 144), (1, 145), (1, 800), (2, 800), (1, 808), (1, 1000), (1, 2000)}
     (tru3, vib3 and control1, theta1, vib9's and tru9's groups, maxG11,
     thetaG11, the tori of phase 41) and at the edges of the kernel's
     regimes, (1, 128), (4, 144), (8, 144), (1, 152), (1, 160), (2, 160),
     (1, 176), (1, 192), (1, 912), (2, 1008) and (1, 2416) ("dsmem" from mp
     64 to 448 (B2), to 288 (B1 of up to 3 matrices) or 464 (B1 of 4 to 7),
     for up to 7 matrices, beside every other one-launch regime that fits
     there (time, us a round, bit equality), and so at its edges (1, 288),
     (1, 304), (3, 304), (4, 304), (1, 448), (1, 464), (7, 464), (7, 480),
     (7, 160) and (8, 160) with no plain version; else "sm" where it fits,
     "cluster" to 912 (B2 of one matrix to 832), "grid" to 2400, then
     "rounds"),
     on clustered (IPM-like) and random spectra, (1, 2000), (2, 1008) and
     (1, 2416) with one sweep: the contracts (after the sweep schedule),
     whether B1 equals the plain version bit for bit (a check in every
     regime; B2's bit equality with "rounds" is one wherever "grid" runs), the
     kernel's, the "rounds" regime's (one launch per round), the plain
     version's and the library call's times (torch.linalg.eigh / eigvalsh
     in f32 on the same tensor) and the bound, and, where the other
     one-launch regime also fits, its time; at (1, 800), (2, 800), (1, 808)
     and (1, 912) "cluster" and "grid" forced (time; B1 and B2 bit for bit,
     a check: the same rotations and Gershgorin order) and, with
     ``--parent ROOT``, the "cluster" kernel of another checkout's
     csrc/jacobi.cu (an earlier commit's, from ``git archive``: time, bit
     equality, a check); at
     (1, 2000) one call of "grid" and of "rounds" with the full sweep
     schedule; fails unless every regime of both kernels ran.
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
     tests/test_precision.py:76-96 below DIMACS 1e-13. On the card
     nt_precision 'auto' is the dd NT scaling under 'dd2' at kit=0 (D1-D3
     must run in every such solve of this process: phases 19, 38, 42).
 20. theta1 on the CG path (kit=1) at 'dd' (DIMACS < 1e-9) and 'dd2'
     (< 1e-10) with the default options: no CG kernel runs under the
     precision tiers, and under 'dd2' 'auto' is the f64 NT scaling on the
     CG path (no D1-D3 launch; ROADMAP Queue C 8).
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
 27. ms per call (CUDA events) and device launches per call (the device
     activities of the larger of two torch.profiler traces,
     `device_launches`: a trace can lose activities) of
     `eigh_jacobi`, `eigh_mixed` with the library seed and with B1's, f64
     `torch.linalg.eigh`, `eigmin_lanczos` and `eigmin_chol`, beside the
     B1 and B2 wrappers, at (nb, m) = (2, 50) and (2, 800) (`eigh_jacobi`
     there from runs of 1 and 2 sweeps).

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
     Phases 34-37 and 38(d) run in a thread of their own beside phases
     17-39, whose times are not checked, and are joined before the kernel
     times of phases 40-41: their ranks are processes of their own, with
     their own launch counts.
 37. the precision tiers on the mesh (ROADMAP item 14b), 2 Gloo ranks on
     the card: theta1 'dd2' (phase 19's options) and tru3 'dd2' on sparse
     storage, both on (1, 2) (the schur axis: theta1's 104 and tru3's 36
     rows split; tru3 has one LMI block, so a blocks axis would replicate
     it): the status and iterations of phase 19's unsharded runs, the
     objective within 1e-12 relative, phase 19's floors (err1 < 1e-18;
     err3 < 1e-15 theta1, < 1e-18 tru3); ms per iteration and B1/B2
     launches per rank.
 38. the native dd NT scaling, nt_precision='dd' (ROADMAP item 12e):
     (a) tests/test_precision.py::test_dd_nt_e2e_cpu's problem (m = 8,
     n = 10, seed 5) solved whole at 'dd2': OPTIMAL, DIMACS < 1e-12,
     err1 < 1e-18; (b) one `nt_scale_dd` at theta1's width (m = 50, padded
     to 56) on phase 19's last dd2 iterate: ms (CUDA events), device
     launches (torch.profiler, one whole call; fails at 1,000 or more, and
     unless D1, D2 and D3 ran 1, 1 and 8 times), dd_ok, W S W = X to 1e-29 of the terms it
     cancels (||W||^2 ||S||; the f64 scaling's error beside it), D within
     1e-14 relative of the port's CPU run on the same iterate;
     (c) a theta1 'dd2' step under nt_precision='dd' from phase 19's
     iterate 14 (`LATE`; a step from the last iterate loses the err1
     floor under either NT scaling, in both packages), gated on
     err1 < 1e-18 at its start and after it, with DIMACS and seconds;
     (d) the one-step cases of the tiers on the mesh (`parallel/dryrun.py`
     `DD_STEPS`: dd, dd2, dd2 kit=1, sparse, rank-1
     and LP data, the dd NT scaling from a late iterate, and with one
     block indefinite, where every rank must take the f64 fallback) on
     (2, 1) Gloo ranks (the blocks split) against one rank's, at
     tests/test_parallel.py's dd2 tolerances.
 39. the examples: each examples/torch_*.py run in this process with
     ``--device cuda`` (its own asserts, those of its JAX twin).
 40. the last two option values ported: gemm_backend='int8' (the integer
     Ozaki GEMM: O1 slicing, O2 the int8 tensor-core product, csrc/
     int8gemm.cu) and chol_backend='mixed' (f32 panels + f64 Newton,
     `ops/mixed_chol.py`). (a) O1 and O2 against their plain versions on
     the card at maxG11's and thetaG11's shapes, a batch of two, odd
     shapes, tests/test_int8gemm.py's graded and cancellation cases and
     fiber maxima at and just below powers of two: O1's slices, exponents
     and scales and O2's product (as planned and in one chunk) bit for
     bit, and within 2^-52 |A||B| of the dd Ozaki product; at maxG11's and
     thetaG11's shapes the kernels', the plain versions', the whole
     product's and torch.matmul's (f64) times, the bounds and the device
     kernels of one whole product (3, or 4 when O2's planner splits the
     weights: the nodes of a CUDA graph captured from it, on every case).
     (b) maxG11 and thetaG11 at full size under 'int8': OPTIMAL at the JAX
     CPU run's objectives, maxG11's iterations within one of phase 4's, ms
     per iteration beside the f64 runs', and `profile_phases`' Schur
     assembly and whole step under either backend. (c) theta1, maxG11 and
     tru9 under 'mixed': OPTIMAL, iterations within 2 of the f64 runs', with
     the panels, f64 fallbacks and host syncs. (d) `chol_mixed_blocked` on
     tests/test_mixed_chol.py's (n, cond) grid against the f64 factor
     (residual < 1e-13, forward difference <= 8 u sqrt(cond)), the panel
     inverse and `chol_reg`'s shifts. (e) the kit=1 materialized route under
     'int8' (a max-cut graph, n = 200, rank-1: theta1-cg's dense data has no
     rank-1 group) beside 'f64': OPTIMAL, same objective to 1e-6, iterations
     within one.
 41. two toroidal max-cut graphs (G-set's family, as maxG11: 4-regular,
     weights +-1 from a seed, `torus_graph`): 40 x 25 (n = 1000, Jacobi mp
     1008) and 50 x 40 (n = 2000, G-set G32's size and edge count), through
     `maxcut_problem` on the card with maxG11's options: (a) the default
     modes, B1 and B2 in "grid", 1 and 2 launches an iteration: status,
     iterations and objective equal to the "rounds" kernel's run
     (TORI_REF: both stop with nt_ok false, the B1 seed's ten sweeps
     leaving the NT scaling indefinite at an early iterate); (b) the same
     solve with "rounds" forced, the same to every digit, ms an iteration
     beside (a)'s; (c) eigh_backend='mixed', step_eig='exact' (no Jacobi
     kernel) and (d) 'mixed' with step_eig='pallas' (B2 "grid", 2 an
     iteration): both OPTIMAL, objectives within 1e-5 relative; (e)
     `profile_phases` of one step at the first iterate.
 42. the dd NT scaling's kernels (csrc/dd_linalg.cu): (a) D1 (the dd
     Jacobi sweeps), D2 (the dd Cholesky) and D3 (the dd GEMM) against
     their plain versions on the card, bit for bit (D2's is the eager
     `dd_chol`), at (nb, m) in DD_SHAPES, on each side of every regime
     boundary (D1 "block", "cluster" of 8 and of 16, "global"; D2 "warp",
     "global": the regimes the library picks for m; fails unless each
     ran), and on phase 19's last theta1 iterate (X, S Lx, Lx^T S Lx at
     m = 56): each call's ms (CUDA events around 20 wrapper calls after a
     warm-up), the kernel's alone (CUDA events around each of 20 launches
     of its C entry, `utils/dd_bench.py`), the plain version's, the bound
     and the launches a call; (b) theta1 at
     'dd2' with the default options (nt_precision 'auto' = dd on the card)
     and with nt_precision='f64': both OPTIMAL with phase 19's floors
     (err1 < 1e-18, err3 < 1e-15), D1-D3 launched in the first only,
     objectives within 1e-10 relative, iterations and ms an iteration;
     the JSON line's D1-D3 launches are those of (b)'s default run.
The reference values of phases 4, 11, 12 and 15 are the JAX package's CPU
runs (`benchmarks/results_cpu_r2.jsonl`). Every solve (phases 3, 4, 7-13,
15, 18-26, 28-33, 38, 40-42) runs with the launch counts set to 0 just
before it and read just after (phases 34-37: in each rank's own process,
around its sharded run), and fails if a kernel of its path was not
launched (B1 and B2 in every precision-tier solve, D1-D3 in every kit=0
'dd2' one of this process under the default NT scaling, O1 and O2 under
'int8') or,
in phases 22-24, if a Jacobi kernel ran where its mode does not resolve to
it. The line before
the last two is a JSON object with one entry per kernel (B1 and B2 twice:
at maxG11's shapes, and in "grid" at mp 1008 with phase 41's launches;
D1-D3 at theta1's (1, 56)); then the card's
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
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

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
from torch_cases import DD2_NT, dd_nt_case, spectrum_matrix  # noqa: E402

THETA1 = "tests/data/theta1.dat-s"
MAXG11 = "tests/data/maxG11.dat-s"
CONTROL1 = "tests/data/control1.dat-s"
TRU9 = "tests/data/tru9.dat-s"
VIB9 = "tests/data/vib9.dat-s"
THETAG11 = "tests/data/thetaG11.dat-s"
THETA1_OPT = 23.0  # SDPLIB optimum
# phase 38(c): the dd NT scaling's step starts from phase 19's theta1 iterate
# after this many iterations (of its 17)
LATE = 14
MAXG11_OPT = 629.1648  # SDPLIB optimum
CONTROL1_OPT = 17.78463  # SDPLIB optimum
# the JAX package on the CPU: objective, iterations (results_cpu_r2.jsonl)
TRU9_REF = (0.05975333, 22)
VIB9_REF = (0.01276683, 34)
THETAG11_REF = (400.00023146, 17)
MAXG11_REF = (629.16479325, 14)
OBJ_RTOL = 1e-5
SHAPES = [(1, 16), (2, 16), (1, 56), (2, 56), (1, 128), (1, 144), (4, 144), (8, 144), (1, 145),
          (1, 152), (1, 160), (2, 160), (1, 176), (1, 192), (1, 800), (2, 800), (1, 808),
          (1, 912), (1, 1000), (1, 2000), (2, 1008), (1, 2416)]
# phase 2 runs these with one sweep (the plain version takes seconds a sweep
# there): bit equality and certified bounds, not a converged seed
ONE_SWEEP = ((1, 2000), (2, 1008), (1, 2416))
# (nb, mp) where phase 2 also forces "grid" beside "cluster", and times the
# "cluster" kernel of ``--parent ROOT`` (maxG11's, thetaG11's, the last size
# a cluster holds)
GRID_VS_CLUSTER = ((1, 800), (2, 800), (1, 816), (1, 912))
# (nb, mp) at the edges of "dsmem" (ops/jacobi.py::DSMEM_TO, DSMEM_TO_FEW,
# CLUSTER_PAIRS, DSMEM_WAVE), where phase 2 forces it beside every other
# one-launch regime that fits
DSMEM_EDGES = ((1, 288), (1, 304), (3, 304), (4, 304), (1, 448), (1, 464), (7, 464), (7, 480),
               (7, 160), (8, 160))
# published peaks of one H100 SXM (NVIDIA data sheet, dense): f32 outside the
# tensor cores, f64 on the tensor cores, HBM3
PEAK_F32, PEAK_F64, PEAK_BYTES = 67e12, 67e12, 3.35e12
# unfused f64 adds and multiplies (DADD, DMUL: dd arithmetic, which the
# tensor cores do not do) a second on the FP64 lanes of an H100 SXM: 132 SMs
# x 64 lanes x 1.98 GHz boost (the data sheet's 34 TFLOP/s FP64 counts an FMA
# as two)
PEAK_F64_LANES = 132 * 64 * 1.98e9
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
# bench.py:77-79 (control1-cg) and :93-95 (theta1-cg, also theta_G100's)
CONTROL1_CG = {"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-6,
               "initpoint": 1, "verb": 0}
THETA1_CG = {"kit": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-5, "preconditioner": 1,
             "initpoint": 1, "verb": 0}
# the precision tiers (phases 18-21): tests/test_precision.py's options
DD = {"kit": 0, "eDIMACS": 1e-11, "initpoint": 1, "verb": 0, "precision": "dd", "maxit": 30}
DD2 = dict(DD, eDIMACS=5e-13, precision="dd2", datasparsity=0)
CG_DD = {"precision": "dd", "kit": 1, "preconditioner": 1, "eDIMACS": 1e-9, "tol_cg_min": 1e-9,
         "initpoint": 1, "verb": 0, "maxit": 40}
CG_DD2 = dict(CG_DD, precision="dd2", eDIMACS=1e-10, tol_cg_min=1e-10, datasparsity=0)
TRU3_DD2 = {"kit": 0, "eDIMACS": 1e-9, "initpoint": 1, "verb": 0, "precision": "dd2"}
LP_DD2 = {"eDIMACS": 1e-13, "verb": 0, "precision": "dd2", "maxit": 40}
THETAG11_OPTS = dict(LARGE_KIT0, datarank=-1)
# tests/test_torch_lp.py: kit=0 at eDIMACS 1e-7 (tests/test_ipm_e2e.py:54-60)
LP_KIT0 = {"kit": 0, "eDIMACS": 1e-7, "initpoint": 1, "verb": 0}
MAXG11_OPTS = {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "datarank": -1, "verb": 0}
MAXG11_DD = dict(MAXG11_OPTS, eDIMACS=1e-8, precision="dd")
KERNELS = ("B1", "B2", "B3", "B4", "polish")
# the integer Ozaki GEMM's kernels (gemm_backend='int8'; phase 40 only)
OZAKI = ("O1", "O2")
# the dd NT scaling's kernels (csrc/dd_linalg.cu: D1 the Jacobi sweeps, D2
# the Cholesky, D3 the GEMM), launched by every dd2 solve on the card
DD_KERNELS = ("D1", "D2", "D3")
DD2_NEEDS = ("B1", "B2") + DD_KERNELS
# phase 42(a): (nb, m) of the dd kernels against their plain versions:
# theta1's m = 56 (the main path's), a batch of two, m = 8, and each side of
# every regime boundary on an H100: D1 "block" to m 20, "cluster" to 264
# (of 8 to 192, of 16 past it: tests/test_torch_cuda.py holds that edge),
# "global" past it; D2 "warp" to m 105, "global" past it. D1 runs 6 sweeps
# (the warm default), 2 past m 84 and 1 past 128 (the plain version takes
# ~5 s a sweep at m 264)
DD_SHAPES = ((1, 8), (2, 8), (1, 20), (1, 22), (1, 56), (2, 56), (2, 96), (1, 104), (1, 106),
             (1, 264), (1, 266))
DD_REGIMES = {"jacobi": {"block", "cluster", "global"}, "chol": {"warp", "global"}}
# the int8 tensor cores' dense peak (NVIDIA data sheet, H100 SXM)
PEAK_INT8 = 1979e12
# phase 40(a): (batch, n, k, c) of the int8 GEMM: maxG11's B G and
# (B G)(B G)^T, thetaG11's B G and (B G)(B G)^T, a batch of two, odd shapes
OZAKI_SHAPES = ((1, 800, 800, 800), (1, 2401, 801, 801), (1, 2401, 801, 2401),
                (2, 800, 800, 800), (1, 17, 23, 9), (1, 128, 40, 96), (1, 33, 801, 65))
# phase 40(d): tests/test_mixed_chol.py:24-25
MIXED_CHOL_GRID = ((64, 128, 200, 333), (1e2, 1e6, 1e10, 1e14))
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
# each launch one dsmem::cluster_kernel: the "dsmem" regime; "cluster_kernel"
# counts it too)
JACOBI_GLOBALS = ("sm_kernel", "cluster_kernel", "dsmem::cluster_kernel", "grid_kernel",
                  "round_kernel", "identity_kernel", "diag_kernel", "gersh_kernel")
# the last phase: toroidal max-cut graphs (rows, cols, seed), n = 1000 (Jacobi
# mp 1008) and n = 2000 (G-set G32's size and edge count), and what the
# "rounds" kernel (one launch per round) gives under TORUS_OPTS (status, iterations,
# objective; PERF.md): the B1 seed's ten sweeps leave the NT scaling
# indefinite at an early iterate (nt_ok false), in every regime
TORI = ((40, 25, 1000), (50, 40, 2000))
TORI_REF = {1000: ("ITERATION_LIMIT", 2, 31334.62108654247),
            2000: ("ITERATION_LIMIT", 4, 71800.24510469122)}
TORUS_OPTS = MAXG11_OPTS


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def lp_synthetic(device="cuda"):
    """The mixed PSD + LP problem of tests/test_precision.py:76-96 (seed 5)."""
    import loraine_tpu_torch as ltt

    rng = np.random.default_rng(5)
    n, m = 6, 5
    A = rng.standard_normal((n, m, m))
    A = (A + A.transpose(0, 2, 1)) / 2
    b = rng.standard_normal(n) * 0.1
    C_lin = rng.standard_normal((n, 4))
    d_lin = np.abs(rng.standard_normal(4)) + 1.0
    return ltt.problem_from_dense([A], [np.eye(m)], b, C_lin=C_lin, d_lin=d_lin,
                                  storage="dense", device=device)


def tru3_sparse(device="cuda"):
    """SDPLIB tru3 forced to sparse storage (tests/test_precision.py:158-160)."""
    import loraine_tpu_torch as ltt

    return ltt.problem_from_sdpa("tests/data/tru3.dat-s", storage="sparse", device=device)


def theta_g100(device="cuda"):
    """Lovasz theta SDP at SDPLIB theta2's size: 100 vertices, edges with
    probability 0.1 from seed 2 (463 edges), n = 464, dense storage
    (`loraine_tpu.models.theta.lovasz_theta_problem` builds the same data)."""
    import loraine_tpu_torch as ltt

    rng = np.random.default_rng(2)
    nv = 100
    E = [(i, j) for i in range(nv) for j in range(i + 1, nv) if rng.random() < 0.1]
    n = 1 + len(E)
    A = np.zeros((n, nv, nv))
    A[0] = np.eye(nv)
    for k, (i, j) in enumerate(E):
        A[k + 1, i, j] = A[k + 1, j, i] = 0.5
    b = np.zeros(n)
    b[0] = 1.0
    return ltt.problem_from_dense([A], [-np.ones((nv, nv))], b, storage="dense", device=device)


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


def forced_run(tj, eigvecs: bool, Mn, sweeps: int, regime: str):
    """One Jacobi call forced into ``regime`` (a comparison: the wrappers
    choose the regime by the shape and the card); B1 (lam, VT) or B2 (g, h)."""
    nb, mp, _ = Mn.shape
    vec = torch.empty((nb, mp), dtype=torch.float32, device=Mn.device)
    outs = (torch.empty_like(Mn), vec) if eigvecs else (vec, torch.empty_like(vec))
    tj._run(eigvecs, Mn, outs, sweeps, regime)
    return (outs[1], outs[0]) if eigvecs else outs


def regime_ms(tj, eigvecs: bool, Mn, sweeps: int, regime: str, reps: int) -> float:
    """Device ms of one Jacobi call forced into ``regime``."""
    return cuda_ms(lambda: forced_run(tj, eigvecs, Mn, sweeps, regime), reps)


def jacobi_library(root: str):
    """csrc/jacobi.cu of another checkout (same C interface), built with this
    checkout's flags into a temporary directory and bound as `tj._lib` binds
    its own; for timing an earlier kernel beside this one in one process."""
    import ctypes
    from loraine_tpu_torch.utils import cuda_build
    out = os.path.join(tempfile.mkdtemp(prefix="jacobi_other_"), "libjacobi.so")
    src = os.path.join(root, "loraine_tpu_torch", "csrc", "jacobi.cu")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    for fn in (lib.lt_jacobi_eigh_f32, lib.lt_jacobi_bounds_f32):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.lt_jacobi_grid_scratch.argtypes = [ctypes.c_int] * 3
    lib.lt_jacobi_grid_scratch.restype = ctypes.c_longlong
    lib._lt_bound = True
    return lib


def with_library(tj, lib, fn):
    """fn() with `tj`'s kernels taken from ``lib``."""
    own = tj._lib
    tj._lib = lambda: lib
    try:
        return fn()
    finally:
        tj._lib = own


def one_launch_fits(tj, mp: int, eigvecs: bool) -> list:
    """The regimes "sm" and "cluster" where a matrix of padded size mp fits
    them (a cluster needs two pairs a block: mp >= 64)."""
    return [r for r in ("sm", "cluster") if (r == "sm" or mp >= 4 * tj.CLUSTER)
            and tj.smem_bytes(r, mp, eigvecs) <= tj.SMEM_LIMIT]


def dsmem_beside(tj, eigvecs: bool, Mn, sweeps: int, reps: int, tag: str) -> None:
    """Forces "dsmem" and every other one-launch regime that fits Mn's
    shape: time and us a round of each, and their bit equality (checked)."""
    kname, mp = ("B1" if eigvecs else "B2"), Mn.shape[-1]
    rounds = sweeps * (mp - 1)
    ref = forced_run(tj, eigvecs, Mn, sweeps, "dsmem")
    ms = regime_ms(tj, eigvecs, Mn, sweeps, "dsmem", reps)
    line = f"{tag}: {kname} dsmem ms={ms:.4f} ({1e3 * ms / rounds:.3f} us/round)"
    for other in one_launch_fits(tj, mp, eigvecs):
        same = all(torch.equal(a, b) for a, b in zip(
            ref, forced_run(tj, eigvecs, Mn, sweeps, other)))
        ms = regime_ms(tj, eigvecs, Mn, sweeps, other, reps)
        line += (f" | {other} ms={ms:.4f} ({1e3 * ms / rounds:.3f} us/round) "
                 f"bitwise_equal_{other}={same}")
        check(same, f"{tag}: {kname} dsmem differs from {other}")
    print(line, flush=True)


def seed_quality(A, lam, V, scale):
    """(max reconstruction error / scale, max orthogonality error) of an f32
    eigenpair seed, in f64."""
    Vd = V.double()
    recon = ((Vd * lam.double()[:, None, :]) @ Vd.mT - A).abs().amax((-1, -2)) / scale
    eye = torch.eye(V.shape[-1], dtype=Vd.dtype, device=Vd.device)
    return float(recon.max()), float((Vd.mT @ Vd - eye).abs().max())


def kernels_vs_plain(tj, parent=None) -> dict:
    """Phase 2. Returns per-kernel max errors and, at the maxG11 shapes B1
    (1, 800) and B2 (2, 800), the kernel's time, the plain version's, the
    library call's and the bound. ``parent``: another checkout's Jacobi
    library (`jacobi_library`), whose "cluster" is timed at
    GRID_VS_CLUSTER."""
    err = {"eigh": 0.0, "bounds": 0.0}
    times = {}
    regimes = {"B1": set(), "B2": set()}
    sms = tj.sm_count(torch.device("cuda"))
    for nb, m in SHAPES:
        one = (nb, m) in ONE_SWEEP
        # the shapes past thetaG11's take seconds in the plain versions
        for kind in ("clustered", "random") if m <= 808 else ("clustered",):
            A = torch.from_numpy(spectrum_matrix(kind, m, nb, seed=1000 * nb + m)).cuda()
            Mn, scale = tj._normalize_pad(A)
            mp = Mn.shape[-1]
            s1, s2 = (1, 1) if one else (tj.jacobi_sweeps_for(m), tj.bound_sweeps_for(m))
            out_k = tj.jacobi_eigh_cuda(Mn, s1)
            lam_k, V_k = tj._sorted_eigh(*out_k, m, scale)
            out_p, pms_e = timed_call(lambda: tj.jacobi_eigh_plain(Mn, s1))
            lam_p, V_p = tj._sorted_eigh(*out_p, m, scale)
            # same operations, each rounded once, in every regime
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
            reps = 10 if m < 100 else 3 if m < 2000 else 2
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
            reg_e, reg_b = tj.regime_for(nb, mp, True, sms), tj.regime_for(nb, mp, False, sms)
            for kname, eigvecs, reg, s in (("B1", True, reg_e, s1), ("B2", False, reg_b, s2)):
                if reg == "dsmem":  # beside each regime it was timed against
                    dsmem_beside(tj, eigvecs, Mn, s, reps, f"phase 2 nb={nb} m={m} mp={mp} {kind}")
                for other in one_launch_fits(tj, mp, eigvecs):
                    if reg in ("sm", "cluster") and other != reg:
                        print(f"phase 2 nb={nb} m={m} mp={mp} {kind}: {kname} {other} regime "
                              f"instead of {reg}: "
                              f"ms={regime_ms(tj, eigvecs, Mn, s, other, reps):.4f}", flush=True)
                if kind == "clustered" and (nb, mp) in GRID_VS_CLUSTER:
                    out = forced_run(tj, eigvecs, Mn, s, "cluster")
                    same = all(torch.equal(a, b) for a, b in zip(
                        forced_run(tj, eigvecs, Mn, s, "grid"), out))
                    line = (f"phase 2 nb={nb} m={m} mp={mp} {kind}: {kname} picked {reg}: cluster "
                            f"ms={regime_ms(tj, eigvecs, Mn, s, 'cluster', reps):.4f} grid "
                            f"ms={regime_ms(tj, eigvecs, Mn, s, 'grid', reps):.4f} "
                            f"bitwise_equal={same}")
                    check(same, f"{kname} grid differs from cluster nb={nb} mp={mp}")
                    if parent is not None:
                        old = with_library(tj, parent, lambda: (
                            forced_run(tj, eigvecs, Mn, s, "cluster"),
                            regime_ms(tj, eigvecs, Mn, s, "cluster", reps)))
                        same = all(torch.equal(a, b) for a, b in zip(old[0], out))
                        line += f" | parent cluster ms={old[1]:.4f} bitwise_equal={same}"
                        check(same, f"{kname} cluster differs from the parent's mp={mp}")
                    print(line, flush=True)
            if reg_b == "grid":  # B2: bit for bit the regime it replaced
                same_b = all(torch.equal(a, b) for a, b in zip(
                    tj.jacobi_bounds_cuda(Mn, s2), forced_run(tj, False, Mn, s2, "rounds")))
                check(same_b, f"B2 grid differs from rounds nb={nb} m={m}")
            check(bitwise, f"B1 {reg_e} differs from the plain version nb={nb} m={m} {kind}")
            regimes["B1"].add(reg_e)
            regimes["B2"].add(reg_b)
            print(
                f"phase 2 nb={nb} m={m} mp={mp} {kind}: B1 {reg_e} sweeps={s1}"
                f"{' (one sweep)' if one else ''} "
                f"bitwise_equal_plain={bitwise} "
                f"|lam-plain|/scale={e_plain:.2e} |lam-f64|/scale={e_f64:.2e} "
                f"recon={recon:.2e} (plain {recon_p:.2e}) orth={orth:.2e} (plain {orth_p:.2e}) "
                f"ms={ms_e:.4f} ({1e3 * ms_e / (s1 * (mp - 1)):.3f} us/round) "
                f"rounds_ms={old_e:.4f} plain_ms={pms_e:.1f} eigh_ms={lib_e:.4f} "
                f"bound_ms={bnd_e[0]:.4f} ({bnd_e[1]}) | "
                f"B2 {reg_b} sweeps={s2} |bound-plain|/scale={b_plain:.2e} slack/scale={slack:.2e} "
                f"(plain {slack_p:.2e}) valid={valid} ms={ms_b:.4f} "
                f"({1e3 * ms_b / (s2 * (mp - 1)):.3f} us/round) rounds_ms={old_b:.4f} "
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
            check(valid, f"B2 bounds not certified nb={nb} m={m} {kind}")
            if not one:  # the seed's contracts hold after the sweep schedule
                check(e_plain < 5e-5 and e_f64 < 5e-5, f"B1 eigenvalues nb={nb} m={m} {kind}")
                check(recon < max(1e-4, 2 * recon_p) and orth < max(1e-4, 2 * orth_p),
                      f"B1 eigenvectors nb={nb} m={m} {kind}")
                check(slack < max(1e-3, 2 * slack_p), f"B2 bounds loose nb={nb} m={m} {kind}")
            err["eigh"] = max(err["eigh"], e_plain)
            err["bounds"] = max(err["bounds"], b_plain)
            if kind == "clustered" and (nb, m) == (1, 800):
                times["eigh"] = (ms_e, pms_e, lib_e, *bnd_e, reg_e)
            if kind == "clustered" and (nb, m) == (2, 800):
                times["bounds"] = (ms_b, pms_b, lib_b, *bnd_b, reg_b)
            if (nb, m) == (1, 1000):  # the 1000-node torus's mp, full sweeps
                times["eigh_grid"] = (ms_e, pms_e, lib_e, *bnd_e, reg_e)
                times["bounds_grid"] = (ms_b, pms_b, lib_b, *bnd_b, reg_b)
            if (nb, m) == (1, 2000):  # the 2000-node torus: full sweeps, old and new
                s1f, s2f = tj.jacobi_sweeps_for(m), tj.bound_sweeps_for(m)
                full = {"B1 grid": timed_call(lambda: tj.jacobi_eigh_cuda(Mn, s1f))[1],
                        "B1 rounds": timed_call(lambda: forced_run(tj, True, Mn, s1f, "rounds"))[1],
                        "B2 grid": timed_call(lambda: tj.jacobi_bounds_cuda(Mn, s2f))[1],
                        "B2 rounds": timed_call(
                            lambda: forced_run(tj, False, Mn, s2f, "rounds"))[1]}
                bnd = {"B1": jacobi_bound(True, nb, mp, s1f),
                       "B2": jacobi_bound(False, nb, mp, s2f)}
                print(f"phase 2 nb={nb} m={m} mp={mp} full sweeps ({s1f}, {s2f}): "
                      + " ".join(f"{k} ms={v:.4f}" for k, v in full.items())
                      + f" bound_ms B1 {bnd['B1'][0]:.4f} B2 {bnd['B2'][0]:.4f}", flush=True)
    for kname, seen in regimes.items():
        check(seen == set(tj.REGIMES), f"{kname}: regimes {sorted(seen)} ran in phase 2")
    # the edges of "dsmem": the sweep schedule, no plain version
    for nb, mp in DSMEM_EDGES:
        A = torch.from_numpy(spectrum_matrix("clustered", mp, nb, seed=1000 * nb + mp)).cuda()
        Mn, _ = tj._normalize_pad(A)
        for eigvecs, s in ((True, tj.jacobi_sweeps_for(mp)), (False, tj.bound_sweeps_for(mp))):
            dsmem_beside(tj, eigvecs, Mn, s, 3, f"phase 2 dsmem edge nb={nb} mp={mp} picked "
                         f"{tj.regime_for(nb, mp, eigvecs, sms)}")
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

    def __init__(self, tj, tp, ti, dl):
        self.jacobi = {"B1": tj.jacobi_eigh_cuda, "B2": tj.jacobi_bounds_cuda}
        self.cg = {"B3": tp.cg_minres_f64_cuda, "B4": tp.cg_f32_cuda, "polish": tp.cg_f64_cuda}
        self.ozaki = {"O1": ti.ozaki_slice_s8_cuda, "O2": ti.ozaki_gemm_s8_cuda}
        self.dd = {"D1": dl.dd_jacobi_cuda, "D2": dl.dd_chol_cuda, "D3": dl.dd_matmul_cuda}
        self.total = dict.fromkeys(KERNELS + OZAKI + DD_KERNELS, 0)

    def run(self, label: str, needs, solve):
        for fn in self.jacobi.values():
            fn.launches_by_mp.clear()
            fn.launches_by_regime.clear()
        for fn in self.cg.values():
            fn.launches = 0
            fn.launches_by_regime.clear()
        for fn in (*self.ozaki.values(), *self.dd.values()):
            fn.launches = 0
        r = solve()
        # the Jacobi kernels' launches per padded size mp, and every
        # kernel's per regime, of this solve
        self.by_mp = {k: dict(sorted(fn.launches_by_mp.items())) for k, fn in self.jacobi.items()}
        self.by_regime = {k: dict(sorted(fn.launches_by_regime.items()))
                          for k, fn in {**self.jacobi, **self.cg}.items()}
        got = {k: sum(v.values()) for k, v in self.by_mp.items()}
        got.update({k: fn.launches for k, fn in {**self.cg, **self.ozaki, **self.dd}.items()})
        for k in KERNELS + OZAKI + DD_KERNELS:
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


def precision_tiers(launches, ltt, maxg11_f64) -> dict:
    """Phases 18-21: the precision tiers end to end on the card, with the
    options of tests/test_precision.py. Returns phase 19's theta1 and tru3
    runs (phases 37-38 start from them)."""
    tru3_dd2, lp_dd2 = TRU3_DD2, LP_DD2
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
    r = launches.run("phase 19 (theta1 dd2)", DD2_NEEDS,
                     lambda: ltt.solve_sdpa(THETA1, DD2, device="cuda"))
    phase19 = {"theta1": r}
    print(tier_line("19 theta1 dd2 (NT auto = dd) cuda", r), flush=True)
    check(r.status == 1 and abs(r.objective - THETA1_OPT) < 1e-9, "theta1 dd2")
    check(r.errs["err1"] < 1e-18 and r.errs["err3"] < 1e-15, "theta1 dd2 residual floors")
    check(r.final_state.X_lo is not None, "theta1 dd2 without tails")
    p = tru3_sparse("cuda")
    check(all(g.is_sparse for g in p.groups), "tru3 not sparse")
    r = launches.run("phase 19 (tru3 sparse dd2)", DD2_NEEDS,
                     lambda: ltt.solve(p, tru3_dd2, device="cuda"))
    phase19["tru3"] = r
    print(tier_line("19 tru3 sparse dd2 (NT auto = dd) cuda", r), flush=True)
    check(r.status == 1 and abs(r.objective - 0.0625018) < 1e-5, "tru3 sparse dd2")
    check(r.errs["err1"] < 1e-18 and r.errs["err3"] < 1e-18, "tru3 sparse dd2 residual floors")
    p = lp_synthetic("cuda")
    r = launches.run("phase 19 (LP synthetic dd2)", DD2_NEEDS,
                     lambda: ltt.solve(p, lp_dd2, device="cuda"))
    print(tier_line("19 LP synthetic dd2 (NT auto = dd) cuda", r), flush=True)
    check(r.status == 1 and r.dimacs < lp_dd2["eDIMACS"], "LP synthetic dd2 DIMACS")

    # ---- phase 20: theta1 on the CG path under dd and dd2: no CG kernel,
    # and under 'dd2' the f64 NT scaling ('auto' at kit=1; ROADMAP Queue C 8)
    for prec, o in (("dd", CG_DD), ("dd2", CG_DD2)):
        r = launches.run(f"phase 20 (theta1 kit=1 {prec})", ("B1", "B2"),
                         lambda: ltt.solve_sdpa(THETA1, o, device="cuda"))
        print(tier_line(f"20 theta1-cg {prec} (NT auto = f64) cuda", r), flush=True)
        check(r.status == 1 and r.dimacs < o["eDIMACS"], f"theta1 kit=1 {prec}")
        check(abs(r.objective - THETA1_OPT) <= 1e-8 * THETA1_OPT, f"theta1 kit=1 {prec} objective")
        ran = {k: sum(v.values()) for k, v in launches.by_regime.items() if k in CG_KERNELS}
        check(not any(ran.values()), f"theta1 kit=1 {prec}: a CG kernel ran {ran}")
        dd_ran = {k: launches.dd[k].launches for k in DD_KERNELS}
        check(not any(dd_ran.values()), f"theta1 kit=1 {prec}: the dd NT kernels ran {dd_ran}")

    # ---- phase 21: maxG11 at full size in dd, beside phase 4's f64 run
    r, wall, peak = large_case(launches, "21", MAXG11, MAXG11_DD, (MAXG11_REF[0], None), ltt)
    r64, wall64, peak64 = maxg11_f64
    med, med64 = (1e3 * float(np.median(x.iteration_times)) for x in (r, r64))
    print(f"phase 21 maxG11 dd vs f64: it {r.iterations} vs {r64.iterations}, dimacs "
          f"{r.dimacs:.3e} vs {r64.dimacs:.3e}, wall {wall:.3f} vs {wall64:.3f} s, solve "
          f"{r.solve_time:.3f} vs {r64.solve_time:.3f} s, median_iter_ms {med:.2f} vs {med64:.2f} "
          f"(ratio {med / med64:.2f}), peak_mem_MiB {peak:.1f} vs {peak64:.1f}", flush=True)
    check(abs(r.objective - MAXG11_REF[0]) <= 1e-6 * MAXG11_REF[0], "maxG11 dd objective")
    return phase19


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
    spectra. Launches and ms of `eigh_jacobi` at m = 800 (~10^5 launches
    and ~1 s a sweep) come from runs of 1 and 2 sweeps (fixed + sweeps x
    per sweep)."""
    from loraine_tpu_torch.ops import eigh as te, jacobi as tj, linalg as tl

    def launched(fn) -> int:
        # a trace can lose activities, never add them (one read 0 for the
        # f64 eigh at (2, 800) after the eager Jacobi's traces): the larger
        # of two traces
        fn()
        torch.cuda.synchronize()
        return max(device_launches(fn), device_launches(fn))

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
                # seconds a call: the traces of 1 and 2 sweeps warm it
                runs = [lambda: te.eigh_jacobi(A, sweeps=1), lambda: te.eigh_jacobi(A, sweeps=2)]
                one, two = (launched(f) for f in runs)
                t1, t2 = (cuda_ms(f, 1, warmup=False) for f in runs)
                n = one + (sweeps - 1) * (two - one)
                ms = t1 + (sweeps - 1) * (t2 - t1)
                how = (f" ({two - one} launches and {t2 - t1:.3f} ms a sweep x {sweeps} sweeps, "
                       f"from 1- and 2-sweep runs)")
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
    check(named["dsmem::cluster_kernel"] == jac["B1"] + jac["B2"] > 0,
          "profile_dir trace does not name one dsmem::cluster_kernel per B1/B2 launch")
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


def mesh_run(phase, nproc, backend, extra, timeout, card: str) -> list:
    """`parallel/dryrun.py` with ``extra`` at ``nproc`` ranks on the card,
    every rank a process of its own: its summary lines, and every rank's
    records. A failed rank or gate fails the launch, and so the phase; so
    does a rank that launched no B1 or no B2."""
    from loraine_tpu_torch.parallel import dryrun
    from loraine_tpu_torch.parallel.distributed import launch

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


def mesh_phases(f64_runs, maxg11_f64, card: str) -> None:
    """Phases 34-36: the mesh through `parallel/dryrun.py`, every rank a
    process of its own on the card."""
    from loraine_tpu_torch.parallel import dryrun

    def run(phase, nproc, backend, extra, timeout):
        return mesh_run(phase, nproc, backend, extra, timeout, card)

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


def dd_mesh_phase(phase19: dict, card: str) -> None:
    """Phase 37: theta1 and tru3 (sparse) at 'dd2' on the (1, 2) mesh, 2 Gloo
    ranks on the card, against phase 19's unsharded runs."""
    # tru3 on sparse storage: the load's threshold picks it for every block
    tru3 = dict(TRU3_DD2, datasparsity=64)
    for name, opts, err3 in (("theta1", DD2, 1e-15), ("tru3", tru3, 1e-18)):
        ref = phase19[name]
        recs = mesh_run(37, 2, "gloo", ["--case", f"sdplib:{name}", "--opts", json.dumps(opts)],
                        600, card)
        for r in recs:
            label = f"phase 37 {name} dd2 rank {r['rank']}"
            check(r["status"] == ref.status == 1, f"{label}: status {r['status']}")
            check(r["iters"][0] == ref.iterations,
                  f"{label}: {r['iters'][0]} iterations, phase 19 {ref.iterations}")
            check(abs(r["sharded"] - ref.objective) <= 1e-12 * abs(ref.objective),
                  f"{label}: objective {r['sharded']!r} != phase 19 {ref.objective!r}")
            check(r["errs"]["err1"] < 1e-18 and r["errs"]["err3"] < err3,
                  f"{label}: residual floors {r['errs']}")
            check(r["sparse"] == (name == "tru3"), f"{label}: storage")
        print(f"phase 37 {name} dd2 (1, 2): obj {recs[0]['sharded']!r} it {recs[0]['iters'][0]} "
              f"err1 {recs[0]['errs']['err1']:.2e} err3 {recs[0]['errs']['err3']:.2e} "
              f"median ms an iteration per rank "
              f"{[round(1e3 * r['median_iter_s'], 2) for r in recs]} B1/B2 per rank "
              f"{[tuple(r['launches'][:2]) for r in recs]} | phase 19: obj {ref.objective!r} "
              f"it {ref.iterations} median ms {1e3 * float(np.median(ref.iteration_times)):.2f}; "
              f"on '{card}'", flush=True)


def device_launches(fn) -> int:
    """The device activities (kernels, copies, fills) of one call of ``fn``
    in a `torch.profiler` trace, counted from its raw events: at ~10^6
    launches `key_averages()` takes minutes."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.profiler.kineto_results.events() if e.device_type() == cuda)


def nt_dd_phase(launches, ltt, phase19: dict, card: str) -> None:
    """Phase 38: the native dd NT scaling (nt_precision='dd') on the card."""
    import loraine_tpu_torch.ipm.step as S
    from loraine_tpu_torch.ops.dd import DD, dd_add, dd_neg
    from loraine_tpu_torch.ops.dd_linalg import dd_matmul
    from loraine_tpu_torch.ops.nt_scaling import nt_scale, nt_scale_dd
    from loraine_tpu_torch.ops.schur import Aop_dd

    # ---- (a) tests/test_precision.py::test_dd_nt_e2e_cpu's solve, whole
    p = dd_nt_case("cuda")
    t0 = time.perf_counter()
    r = launches.run("phase 38a", DD2_NEEDS, lambda: ltt.solve(p, DD2_NT, device="cuda"))
    print(tier_line("38a m=8 dd2 nt_precision=dd cuda", r)
          + f" wall={time.perf_counter() - t0:.3f} s median_iter_ms="
          f"{1e3 * float(np.median(r.iteration_times)):.2f} on '{card}'", flush=True)
    check(r.status == 1 and r.dimacs < 1e-12 and r.errs["err1"] < 1e-18,
          f"phase 38a: {r.status_name} dimacs {r.dimacs:.3e} err1 {r.errs['err1']:.3e}")

    # ---- (b) one nt_scale_dd at theta1's width on phase 19's last iterate
    fs = phase19["theta1"].final_state
    X, Sd = DD(fs.X[0], fs.X_lo[0]), DD(fs.S[0], fs.S_lo[0])
    # the device launches of one whole call (also the warm-up), then its time
    dd_before = {k: fn.launches for k, fn in launches.dd.items()}
    n_launch = device_launches(lambda: nt_scale_dd(X, Sd))
    per_call = {k: fn.launches - dd_before[k] for k, fn in launches.dd.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    nts, tails = nt_scale_dd(X, Sd)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    # W S W = X cancels terms of size ||W||^2 ||S||: dd class is a few
    # 2^-104 of that (the f64 scaling's error beside it)
    terms = float(nts.W.abs().max()) ** 2 * float(Sd.hi.abs().max())

    def wsw_err(W):  # the difference taken in dd: collapsed to f64 first it is u64 ||X||
        WSW = dd_matmul(W, dd_matmul(Sd, W))
        return float(((WSW.hi - X.hi) + (WSW.lo - X.lo)).abs().max())

    wsw = wsw_err(DD(nts.W, tails.W_lo))
    W64 = nt_scale(X.hi, Sd.hi).W
    wsw64 = wsw_err(DD(W64, torch.zeros_like(W64)))
    t0 = time.perf_counter()
    cpu_nts, cpu_tails = nt_scale_dd(DD(X.hi.cpu(), X.lo.cpu()), DD(Sd.hi.cpu(), Sd.lo.cpu()))
    cpu_s = time.perf_counter() - t0
    D = nts.D.cpu() + tails.D_lo.cpu()
    D_cpu = cpu_nts.D + cpu_tails.D_lo
    d_rel = float(((D - D_cpu) / D_cpu).abs().max())
    m = X.hi.shape[-1]
    print(f"phase 38b nt_scale_dd theta1 (nb, m)=(1, {m}) at phase 19's last iterate (mu "
          f"{phase19['theta1'].history[-1]['mu']:.3e}): ms={ms:.3f} device launches={n_launch} "
          f"(D1-D3 {per_call}) "
          f"dd_ok={bool(tails.dd_ok)} "
          f"|WSW-X| {wsw:.2e} = {wsw / terms:.2e} of ||W||^2 ||S|| (f64 nt_scale: {wsw64:.2e}) "
          f"D min {float(D.min()):.3e} max {float(D.max()):.3e} vs CPU port max rel "
          f"{d_rel:.2e} (CPU {cpu_s:.1f} s) on '{card}'", flush=True)
    check(bool(tails.dd_ok) and bool(cpu_tails.dd_ok), "phase 38b: dd_ok")
    check(n_launch < 1000, f"phase 38b: {n_launch} device launches in one call")
    check(per_call == {"D1": 1, "D2": 1, "D3": 8}, f"phase 38b: dd kernel launches {per_call}")
    check(wsw < 1e-29 * terms, f"phase 38b: W S W - X at {wsw / terms:.2e} of the terms")
    check(d_rel < 1e-14, f"phase 38b: D {d_rel:.2e} from the CPU port's")

    # ---- (c) a theta1 dd2 step under nt_precision='dd' from phase 19's
    # iterate after LATE iterations (a step from its last iterate, at mu
    # ~4e-14, already loses the dd2 floor of err1 under either NT scaling,
    # in both packages: ROADMAP Queue C 4). err1 is the residual of the
    # step's start; its result is read after it.
    o = ltt.Options.from_dict(dict(DD2, nt_precision="dd")).validated()
    pt = ltt.load_problem(THETA1, o, device="cuda")
    o = o.resolved(pt, "cuda")
    st = ltt.solve(pt, dict(DD2, maxit=LATE), device="cuda").final_state
    ref = phase19["theta1"].history
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, stats = S.step(pt, st, o)
    h = stats.to_host()
    print(f"phase 38c theta1 dd2 nt_precision=dd step from iteration {LATE}: "
          f"dimacs {h['dimacs']:.3e} (phase 19, NT auto = dd: {ref[LATE]['dimacs']:.3e}) "
          f"err1 {h['err1']:.2e} err5 {h['err5']:.2e} mu {h['mu']:.3e} "
          f"{time.perf_counter() - t0:.2f} s on '{card}'", flush=True)
    check(h["nt_ok"] and h["h_ok"] and h["err1"] < 1e-18 and math.isfinite(h["dimacs"]),
          f"phase 38c step: {h}")
    Rp = DD(pt.b, torch.zeros_like(pt.b))
    for g, X, Xl in zip(pt.groups, st.X, st.X_lo):
        Rp = dd_add(Rp, dd_neg(Aop_dd(g, X, Xl)))
    err1 = float(torch.linalg.norm(Rp.hi + Rp.lo) / (1.0 + torch.linalg.norm(pt.b)))
    print(f"phase 38c after the step: err1 {err1:.2e}", flush=True)
    check(err1 < 1e-18, f"phase 38c: err1 {err1:.2e} after the step")


# f64 operations of the dd primitives as csrc/dd_linalg.cu writes them
# (each + - * / sqrt one): dd_add 28, dd_mul 26, dd_div 121, dd_sqrt 58,
# one Jacobi rotation 709 (the branch of t it takes); a rotated entry is
# 2 dd_mul + dd_add
DD_ADD, DD_MUL, DD_DIV, DD_SQRT, DD_ROT = 28, 26, 121, 58, 709


def chol_tree_ops(m: int, j: int) -> int:
    """f64 operations of one row's t_i at column j as D2 forms it: the
    products of the computed columns k < j (the others are exact zeros),
    and the tree's adds but those of two zeros."""
    if m == 1 or j == 0:
        return 0
    half = m // 2
    ops = sum(DD_MUL * (1 + (s + half < j)) + DD_ADD for s in range(min(half, j)))
    ops += DD_ADD if m % 2 else 0
    n = half
    while n > 1:
        half = n // 2
        ops += DD_ADD * (min(half, j) + (n % 2))
        n = half
    return ops


def dd_kernel_bound(kernel: str, nb: int, m: int, sweeps: int = 0):
    """(bound ms, bound_by) of D1 ("jacobi", ``sweeps`` sweeps), D2
    ("chol") or D3 ("gemm", m x m @ m x m): the f64 operations above over
    the FP64 lanes' rate of unfused adds and multiplies, or each input read
    and each output written once over the memory rate."""
    if kernel == "jacobi":  # A and V in and out
        rnd = (m // 2) * DD_ROT + 3 * m * m * (2 * DD_MUL + DD_ADD)
        flops = nb * sweeps * ((m - 1) * rnd + m * m * (DD_ADD + 2))
        nbytes = 8 * nb * 8 * m * m
    elif kernel == "chol":  # every column: the trees, c, the pivot, the divisions
        flops = nb * sum((m - j) * (chol_tree_ops(m, j) + DD_ADD + DD_DIV) + DD_SQRT
                         for j in range(m))
        nbytes = 8 * nb * 4 * m * m + nb
    else:
        flops = nb * m * m * m * (DD_MUL + DD_ADD)
        nbytes = 8 * nb * 6 * m * m
    return bound_ms(flops, nbytes, PEAK_F64_LANES)


def dd_kernels_phase(launches, ltt, phase19: dict, card: str) -> dict:
    """Phase 42. (a) D1, D2 and D3 against their plain versions on the card,
    bit for bit, at DD_SHAPES and on phase 19's last theta1 iterate (X, S
    and M = Lx^T S Lx at m = 56), each call's time (CUDA events after a
    warm-up), the kernel's alone, the plain version's, the bound and the
    launches a call; (b) theta1 at dd2 with the default options (NT 'auto'
    = dd on the card) beside nt_precision='f64'. Returns the JSON rows'
    numbers of D1-D3 at the main path's (1, 56), with their launches in
    (b)'s default run."""
    from loraine_tpu_torch.ops import dd_linalg as dl
    from loraine_tpu_torch.ops.dd import DD
    from loraine_tpu_torch.utils.dd_bench import alone_ms, launcher

    rng = np.random.default_rng(42)

    def dd_in(x):
        x = torch.from_numpy(x)
        return DD(x.cuda(), (x * 1e-17 * torch.from_numpy(rng.standard_normal(x.shape))).cuda())

    def held(name, kernel, plain, shape, kind, args, sweeps=0):
        before = {k: fn.launches for k, fn in launches.dd.items()}
        out = kernel()
        per_call = {k: fn.launches - before[k] for k, fn in launches.dd.items()
                    if fn.launches > before[k]}
        ref, plain_ms = timed_call(plain)
        torch.cuda.synchronize()
        flat = lambda t: [x for y in t for x in (y if isinstance(y, tuple) else (y,))]  # noqa: E731
        err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(flat(out), flat(ref)))
        check(all(torch.equal(a, b) for a, b in zip(flat(out), flat(ref))),
              f"phase 42a: {name} at {shape} differs from its plain version (max {err:.3e})")
        ms = cuda_ms(kernel, 20)
        alone = alone_ms(*launcher(dl, kind, *args, sweeps=sweeps))
        bnd, by = dd_kernel_bound(kind, shape[0], shape[1], sweeps)
        print(f"phase 42a {name} {shape}: bitwise equal to the plain version; ms={ms:.4f} "
              f"kernel_ms={alone:.4f} plain_ms={plain_ms:.2f} bound_ms={bnd:.5f} ({by}) "
              f"launches a call {per_call}", flush=True)
        return {"ms": ms, "kernel_ms": alone, "plain_ms": plain_ms, "bound_ms": bnd,
                "bound_by": by, "max_abs_err": err, "shape": list(shape)}

    regimes = {"jacobi": set(), "chol": set()}
    for nb, m in DD_SHAPES:
        A = dd_in(spectrum_matrix("clustered", m, nb, seed=m))
        B = dd_in(rng.standard_normal((nb, m, m)))
        eye = torch.eye(m, dtype=torch.float64, device="cuda").expand(nb, m, m).contiguous()
        V0 = DD(eye, torch.zeros_like(eye))
        sweeps = 6 if m <= 84 else 2 if m <= 128 else 1
        plan = {k: dl.plan_for(k, m)[:2] for k in regimes}
        held("D3 dd_gemm", lambda: dl.dd_matmul_cuda(A, B), lambda: dl.dd_matmul_plain(A, B),
             (nb, m), "gemm", (A, B))
        held(f"D2 dd_chol ({plan['chol'][0]})", lambda: dl.dd_chol_cuda(A),
             lambda: dl.dd_chol_plain(A), (nb, m), "chol", (A,))
        held(f"D1 dd_jacobi ({plan['jacobi'][0]} of {plan['jacobi'][1]}, {sweeps} sweeps)",
             lambda: dl.dd_jacobi_cuda(A, V0, sweeps), lambda: dl.dd_jacobi_plain(A, V0, sweeps),
             (nb, m), "jacobi", (A, V0), sweeps)
        for k in regimes:
            regimes[k].add(plan[k][0])
    check(regimes == DD_REGIMES, f"phase 42a: D1/D2 ran in the regimes {regimes}")
    # the main path's data: phase 19's last theta1 iterate (the JSON rows)
    fs = phase19["theta1"].final_state
    X, S = DD(fs.X[0], fs.X_lo[0]), DD(fs.S[0], fs.S_lo[0])
    m = X.hi.shape[-1]
    rows = {"D2": held("D2 dd_chol on theta1's X", lambda: dl.dd_chol_cuda(X),
                       lambda: dl.dd_chol_plain(X), (1, m), "chol", (X,))}
    L = dl.dd_chol_plain(X)[0]
    rows["D3"] = held("D3 dd_gemm on theta1's S Lx", lambda: dl.dd_matmul_cuda(S, L),
                      lambda: dl.dd_matmul_plain(S, L), (1, m), "gemm", (S, L))
    M = dl.dd_sym(dl.dd_matmul_plain(dl.dd_transpose(L), dl.dd_matmul_plain(S, L)))
    eye = torch.eye(m, dtype=torch.float64, device="cuda")[None].contiguous()
    V0 = DD(eye, torch.zeros_like(eye))
    rows["D1"] = held("D1 dd_jacobi on theta1's Lx^T S Lx", lambda: dl.dd_jacobi_cuda(M, V0, 6),
                      lambda: dl.dd_jacobi_plain(M, V0, 6), (1, m), "jacobi", (M, V0), 6)

    # ---- (b) theta1 at dd2: the default NT ('auto' = dd here) and 'f64'
    res = {}
    for nt in ("auto", "f64"):
        o = DD2 if nt == "auto" else dict(DD2, nt_precision="f64")
        res[nt] = r = launches.run(f"phase 42b (theta1 dd2, nt_precision={nt})",
                                   DD2_NEEDS if nt == "auto" else ("B1", "B2"),
                                   lambda: ltt.solve_sdpa(THETA1, o, device="cuda"))
        ran = {k: launches.dd[k].launches for k in DD_KERNELS}
        print(tier_line(f"42b theta1 dd2 nt_precision={nt} cuda", r)
              + f" ms an iteration {1e3 * r.solve_time / r.iterations:.2f} (median "
              f"{1e3 * float(np.median(r.iteration_times)):.2f}) D1-D3 {ran} on '{card}'",
              flush=True)
        check(r.status == 1 and r.errs["err1"] < 1e-18 and r.errs["err3"] < 1e-15,
              f"phase 42b nt_precision={nt}: {r.status_name} {r.errs}")
        check(any(ran.values()) == (nt == "auto"), f"phase 42b nt_precision={nt}: D1-D3 {ran}")
        if nt == "auto":  # the main path's run: the JSON rows' launches
            for k_ in DD_KERNELS:
                rows[k_]["launches"] = ran[k_]
    rel = abs(res["auto"].objective - res["f64"].objective) / abs(res["f64"].objective)
    print(f"phase 42b objectives dd NT {res['auto'].objective!r} f64 NT "
          f"{res['f64'].objective!r} rel {rel:.2e}; iterations {res['auto'].iterations} vs "
          f"{res['f64'].iterations}", flush=True)
    check(rel <= 1e-10, f"phase 42b: objectives {rel:.2e} apart")
    return rows


def dd_steps_mesh(card: str) -> None:
    """Phase 38(d): the one-step cases of the tiers (`dryrun.DD_STEPS`: dd2,
    the dd NT scaling from a late iterate, one block indefinite, ...) on
    (2, 1) Gloo ranks, each against the unsharded step."""
    from loraine_tpu_torch.parallel.dryrun import DD_STEPS

    recs = mesh_run(38, 2, "gloo", ["--case", "dd_steps"], 600, card)
    check(sorted((r["rank"], r["case"]) for r in recs)
          == sorted((k, f"dd_steps {c}") for k in range(2) for c in DD_STEPS),
          "phase 38d: steps missing")
    for r in recs:
        if r["dd_ok"] is not None:
            print(f"phase 38d rank {r['rank']} {r['case']}: dd_ok unsharded/sharded "
                  f"{r['dd_ok']} max |dX| {r['max_abs_dX']:.2e} {r['seconds']:.2f} s", flush=True)


def timed(fn, *args) -> float:
    """Wall seconds of fn(*args)."""
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def examples_phase() -> None:
    """Phase 39: each examples/torch_*.py with --device cuda, in this
    process (their asserts fail the phase)."""
    import runpy

    for path in sorted(glob.glob("examples/torch_*.py")):
        argv = sys.argv
        sys.argv = [path, "--device", "cuda"]
        t0 = time.perf_counter()
        try:
            with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
                runpy.run_path(path, run_name="__main__")
        finally:
            sys.argv = argv
        print(f"phase 39 {path} --device cuda: ok in {time.perf_counter() - t0:.2f} s", flush=True)


def ozaki_bounds(nb: int, n: int, k: int, c: int, s: int, pairs: int):
    """(O1 on A [nb, n, k], O2 for [nb, n, k] @ [nb, k, c]) bounds. O1: per
    element and slice an f64 multiply, a rounding, a multiply and a
    subtraction; X read once, s slices and each fiber's exponent (int32) and
    scale (f64) written once. O2: 2 n c k int8 operations per slice pair;
    both operands' slices and scales read once, the f64 product written
    once."""
    kp = (k + 15) // 16 * 16
    o1 = bound_ms(4 * s * nb * n * k, 8 * nb * n * k + 12 * nb * n + s * nb * n * kp, PEAK_F64)
    o2 = bound_ms(2 * nb * n * c * k * pairs,
                  s * nb * (n + c) * kp + 8 * nb * (n + c) + 8 * nb * n * c, PEAK_INT8)
    return o1, o2


def pow2_maxima(n: int, k: int, c: int, seed: int):
    """A [1, n, k] and B [1, k, c] whose row and column maxima are exactly
    2^j or the double just below it (j from -60 to 59)."""
    rng = np.random.default_rng(seed)
    A, B = rng.uniform(-1, 1, (1, n, k)), rng.uniform(-1, 1, (1, k, c))
    js = rng.integers(-60, 60, max(n, c))
    for i in range(n):
        top = 2.0 ** js[i]
        A[0, i] *= top / 2
        A[0, i, i % k] = top if i % 2 else np.nextafter(top, 0)
    for j in range(c):
        top = 2.0 ** js[j]
        B[0, :, j] *= top / 2
        B[0, j % k, j] = -top if j % 2 else -np.nextafter(top, 0)
    return A, B


def graph_kernels(fn) -> tuple:
    """(kernels, all nodes) of a CUDA graph captured from one call of ``fn``:
    every launch the call makes on its stream becomes a node, so this counts
    exactly where a torch.profiler trace can miss an activity (it read 0
    after phases 38-39, and one kernel short once in a fresh process)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        t = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0,
              "cuGraphNodeGetType failed")
        kinds.append(t.value)
    g.reset()
    return kinds.count(0), len(kinds)  # CU_GRAPH_NODE_TYPE_KERNEL = 0


def ozaki_vs_plain(ti) -> dict:
    """Phase 40(a): O1 and O2 (csrc/int8gemm.cu) against their plain
    versions on the card at `OZAKI_SHAPES`, on tests/test_int8gemm.py's
    graded and cancellation cases and on maxima at and just below powers of
    two: O1's slices, exponents and scales and O2's product bit for bit (O2
    as the planner splits it and in one chunk), and the product within
    2^-52 |A| |B| of the dd-accurate Ozaki product (`ops/ozaki.py:acc_matmul`,
    ~2^-106). At maxG11's and thetaG11's shapes: O1's, O2's, the plain
    versions', the whole product's and torch.matmul's (f64, the same
    operands) times and the bounds. On every case, the device kernels of
    one whole product (at most 4), from a captured CUDA graph. Returns
    maxG11's times per kernel and each kernel's largest difference from its
    plain version."""
    from loraine_tpu_torch.ops.ozaki import acc_matmul

    s = 11
    sched = ti.pair_schedule(s, 55)
    tmax, pairs = sched[-1][0], sum(len(ps) for _, ps in sched)
    rng = np.random.default_rng(40)
    cases = []
    for nb, n, k, c in OZAKI_SHAPES:
        cases.append((f"{nb}x[{n},{k}]@[{k},{c}]", rng.standard_normal((nb, n, k)),
                      rng.standard_normal((nb, k, c))))
    g = np.random.default_rng(0)
    cases.append(("graded 1e+-100", (g.standard_normal((32, 48))
                                     * np.logspace(-100, 100, 32)[:, None])[None],
                  (g.standard_normal((48, 16)) * np.logspace(80, -80, 16)[None, :])[None]))
    kc = 1 << 14
    big = np.random.default_rng(2).standard_normal(kc // 2) * 1e8
    Ac = np.concatenate([big, -big])[None, None, :]
    Ac[0, 0, -1] += 1.0
    cases.append(("cancellation k=2^14", Ac, np.ones((1, kc, 1))))
    cases.append(("maxima at and below 2^j", *pow2_maxima(300, 200, 260, 12)))
    out, worst = {}, {"O1": 0.0, "O2": 0.0}
    for label, An, Bn in cases:
        A, B = torch.from_numpy(An).cuda(), torch.from_numpy(Bn).cuda()
        nb, n, k = A.shape
        c = B.shape[-1]
        Asl, ea, sa = ti.ozaki_slice_s8_cuda(A, s)
        Bsl, eb, sb = ti.ozaki_slice_s8_cuda(B.mT, s)
        plan = ti.gemm_plan(nb, n, c, Asl.shape[-1], s, tmax,
                            torch.cuda.get_device_properties(0).multi_processor_count)
        O = ti.ozaki_gemm_s8_cuda(Asl, Bsl, sa, sb, tmax, plan=plan)
        O1c = ti.ozaki_gemm_s8_cuda(Asl, Bsl, sa, sb, tmax,
                                    plan=ti.plan_for(nb, n, c, s, (0, tmax + 1)))
        pa, pea, psa = ti.slice_plain(A, s)
        pb, peb, psb = ti.slice_plain(B.mT, s)
        qa, qb = ti._slice_int8(A, -1, s)[0], ti._slice_int8(B, -2, s)[0]
        P = ti._ozaki_sum(qa, qb, psa[..., None], psb[:, None], 55)
        whole, whole_p = ti.matmul_f64_mxu(A, B), ti.matmul_f64_int8_plain(A, B)
        torch.cuda.synchronize()
        same_sl = torch.equal(Asl, pa) and torch.equal(Bsl, pb)
        same_e = (torch.equal(ea, pea) and torch.equal(eb, peb) and torch.equal(sa, psa)
                  and torch.equal(sb, psb))
        same = torch.equal(O, P) and torch.equal(O1c, P) and torch.equal(whole, whole_p)
        diff = max(float((O - P).abs().max()), float((O1c - P).abs().max()))
        diff_sl = max(int((Asl.int() - pa.int()).abs().max()),
                      int((Bsl.int() - pb.int()).abs().max()),
                      int((ea - pea).abs().max()), int((eb - peb).abs().max()))
        worst = {"O1": max(worst["O1"], float(diff_sl)), "O2": max(worst["O2"], diff)}
        ref = acc_matmul(A, B)
        scale = A.abs() @ B.abs()
        rel = float((((whole - ref.hi) - ref.lo).abs() / scale).max())
        kernels, nodes = graph_kernels(lambda: ti.matmul_f64_mxu(A, B))
        print(f"phase 40a {label}: O1 slices bitwise_equal_plain={same_sl} exponents and scales "
              f"bitwise_equal_plain={same_e} | O2 (chunks {plan.tlo}, and one chunk) and the "
              f"whole product bitwise_equal_plain={same} max|O2-plain|={diff:.1e} "
              f"max err/(|A||B|) vs dd product={rel:.2e} (f64 GEMM: "
              f"{float((((A @ B - ref.hi) - ref.lo).abs() / scale).max()):.2e}) | whole product: "
              f"{kernels} device kernels, {nodes} graph nodes", flush=True)
        check(same_sl and same_e, f"phase 40a {label}: O1 differs from its plain version")
        check(same, f"phase 40a {label}: O2 differs from its plain version")
        check(rel <= 2.0**-52, f"phase 40a {label}: error {rel:.2e} > 2^-52 |A||B|")
        # O1 twice, O2, and its epilogue when the planner splits the weights
        check(kernels == nodes == 3 + (len(plan.order) > 1),
              f"phase 40a {label}: a whole product ran {kernels} device kernels "
              f"({nodes} graph nodes), planned chunks {plan.tlo}")
        if label.startswith("cancellation"):
            check(abs(float(whole[0, 0, 0]) - 1.0) <= 1e-6, "phase 40a: cancellation residual")
        if (nb, n, k, c) not in OZAKI_SHAPES[:3]:
            continue
        (b1, by1), (b2, by2) = ozaki_bounds(nb, n, k, c, s, pairs)
        reps = 20
        t = {
            "O1": {"ms": cuda_ms(lambda: ti.ozaki_slice_s8_cuda(A, s), reps),
                   "plain_ms": cuda_ms(lambda: ti.slice_plain(A, s), reps),
                   "library_ms": None, "bound_ms": b1, "bound_by": by1, "shape": [nb, n, k]},
            "O2": {"ms": cuda_ms(lambda: ti.ozaki_gemm_s8_cuda(Asl, Bsl, sa, sb, tmax), reps),
                   "plain_ms": cuda_ms(lambda: ti._ozaki_sum(qa, qb, sa[..., None],
                                                             sb[:, None], 55), reps),
                   "library_ms": cuda_ms(lambda: torch.matmul(A, B), reps),
                   "bound_ms": b2, "bound_by": by2, "shape": [nb, n, k, c]},
        }
        o1_b = cuda_ms(lambda: ti.ozaki_slice_s8_cuda(B.mT, s), reps)
        o2_one = cuda_ms(lambda: ti.ozaki_gemm_s8_cuda(
            Asl, Bsl, sa, sb, tmax, plan=ti.plan_for(nb, n, c, s, (0, tmax + 1))), reps)
        whole_ms = cuda_ms(lambda: ti.matmul_f64_mxu(A, B), reps)
        # O2 in one chunk: each CTA runs all 76 pairs of its tile, and each
        # pair moves 128 + 128 / CLUSTER bytes per k (whole 128-byte
        # k-tiles) from L2 into it: the average L2-to-SM rate of the kernel
        one = ti.plan_for(nb, n, c, s, (0, tmax + 1))
        slots = torch.cuda.get_device_properties(0).multi_processor_count // ti.CLUSTER
        l2_rate = (one.tiles * pairs * (128 + 128 // ti.CLUSTER) * 128
                   * -(-Asl.shape[-1] // 128) / (1e-3 * o2_one) / 1e12)
        print(f"phase 40a time {label}: O1 (A) ms={t['O1']['ms']:.4f} (B, strided read: "
              f"{o1_b:.4f}) plain={t['O1']['plain_ms']:.4f} bound={b1:.4f} ({by1}) | O2 "
              f"ms={t['O2']['ms']:.4f} (chunks {plan.tlo}; one chunk {o2_one:.4f}) "
              f"plain={t['O2']['plain_ms']:.4f} bound={b2:.4f} ({by2}) | whole matmul_f64_mxu "
              f"ms={whole_ms:.4f}, {kernels} device kernels | torch.matmul f64 "
              f"ms={t['O2']['library_ms']:.4f} | {pairs} int8 products | one chunk: "
              f"{one.tiles // ti.CLUSTER} clusters on {slots} cluster slots, L2 to SM "
              f"{l2_rate:.2f} TB/s on average", flush=True)
        if (nb, n, k, c) == OZAKI_SHAPES[0]:
            out.update(t)
    for kname in worst:
        out[kname]["max_abs_err"] = worst[kname]
    return out


def int8_mixed_phase(launches, ltt, maxg11, thetag11, f64_runs, card: str) -> None:
    """Phase 40(b)-(e): the two option values ported last, on the card."""
    from loraine_tpu_torch.models.maxcut import maxcut_problem
    from loraine_tpu_torch.ops import mixed_chol as tm
    from loraine_tpu_torch.ops.linalg import chol_reg
    from loraine_tpu_torch.utils.diagnostics import profile_phases

    def med(r):
        return 1e3 * float(np.median(r.iteration_times))

    # ---- (b) maxG11 and thetaG11 under gemm_backend='int8'
    for name, path, opts, ref, f64 in (("maxG11", MAXG11, MAXG11_OPTS, MAXG11_REF, maxg11),
                                       ("thetaG11", THETAG11, THETAG11_OPTS, THETAG11_REF,
                                        thetag11)):
        r = large_case(launches, "40b", path, dict(opts, gemm_backend="int8"), ref, ltt,
                       needs=("B1", "B2") + OZAKI)[0]
        print(f"phase 40b {name} gemm_backend=int8: it {r.iterations} (f64 {f64.iterations}) "
              f"median ms/it {med(r):.2f} (f64 {med(f64):.2f}) obj {r.objective!r} "
              f"(f64 {f64.objective!r}) on '{card}'", flush=True)
        if name == "maxG11":
            check(abs(r.iterations - f64.iterations) <= 1, "phase 40b maxG11 iterations vs f64")
        # the layer: one Schur assembly and one whole step at an iterate
        # three steps in, under each backend in turn (CUDA events)
        prob = ltt.load_problem(path, opts, device="cuda")
        rows = {gb: profile_phases(prob, dict(opts, gemm_backend=gb)) for gb in ("f64", "int8")}
        print(f"phase 40b {name} profile_phases: Schur assembly (BBBB) ms f64 "
              f"{1e3 * rows['f64']['Schur assembly (BBBB)']:.3f} int8 "
              f"{1e3 * rows['int8']['Schur assembly (BBBB)']:.3f} | full step ms f64 "
              f"{1e3 * rows['f64']['full fused step']:.2f} int8 "
              f"{1e3 * rows['int8']['full fused step']:.2f} on '{card}'", flush=True)

    # ---- (c) theta1, maxG11 and tru9 under chol_backend='mixed'
    for name, path, opts, ref, f64 in (
            ("theta1", THETA1, THETA1_K0, (THETA1_OPT, None), f64_runs["theta1"]),
            ("maxG11", MAXG11, MAXG11_OPTS, MAXG11_REF, maxg11),
            ("tru9", TRU9, LARGE_KIT0, TRU9_REF, f64_runs["tru9"])):
        before = dict(tm.STATS)
        r = large_case(launches, "40c", path, dict(opts, chol_backend="mixed"), ref, ltt)[0]
        d = {k: tm.STATS[k] - before[k] for k in tm.STATS}
        print(f"phase 40c {name} chol_backend=mixed: it {r.iterations} (f64 {f64.iterations}) "
              f"panels {d['panels']} ({d['panels'] / r.iterations:.1f}/it) f64 fallbacks "
              f"{d['fallbacks']} host syncs {d['syncs']} ({d['syncs'] / r.iterations:.1f}/it) "
              f"median ms/it {med(r):.2f} (f64 {med(f64):.2f}) on '{card}'", flush=True)
        check(d["panels"] > 0, f"phase 40c {name}: no mixed panel")
        check(abs(r.iterations - f64.iterations) <= 2, f"phase 40c {name} iterations vs f64")

    # ---- (d) the mixed factorization against the f64 factor on the card
    u = 2.0**-53
    for n in MIXED_CHOL_GRID[0]:
        line = []
        for cond in MIXED_CHOL_GRID[1]:
            rng = np.random.default_rng(n)
            Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
            M = torch.from_numpy(Q @ np.diag(np.logspace(0, -np.log10(cond), n)) @ Q.T).cuda()
            before = tm.STATS["fallbacks"]
            L = tm.chol_mixed_blocked(M)
            L64 = torch.linalg.cholesky(M)
            resid = float(torch.linalg.norm(M - L @ L.T) / torch.linalg.norm(M))
            fwd = float(torch.linalg.norm(L - L64) / torch.linalg.norm(L64))
            line.append(f"cond {cond:.0e}: resid {resid:.1e} vs f64 factor {fwd:.1e} "
                        f"fallbacks {tm.STATS['fallbacks'] - before}")
            check(not bool(torch.isnan(L).any()) and resid < 1e-13
                  and float(torch.triu(L, 1).abs().max()) == 0.0,
                  f"phase 40d n={n} cond={cond:.0e}: resid {resid:.1e}")
            check(fwd <= 8 * u * math.sqrt(cond), f"phase 40d n={n} cond={cond:.0e}: {fwd:.1e}")
        print(f"phase 40d chol_mixed_blocked n={n}: " + "; ".join(line), flush=True)
    rng = np.random.default_rng(11)
    Q = np.linalg.qr(rng.standard_normal((128, 128)))[0]
    M = torch.from_numpy(Q @ np.diag(np.logspace(0, -8, 128)) @ Q.T).cuda()
    L, Li = tm.panel_chol_mixed(M)
    err = float(torch.linalg.norm(Li @ L - torch.eye(128, dtype=M.dtype, device=M.device)))
    rng = np.random.default_rng(3)
    Q = np.linalg.qr(rng.standard_normal((160, 160)))[0]
    M = torch.from_numpy(Q @ np.diag(np.logspace(0, -6, 160)) @ Q.T - 1.5e-4 * np.eye(160)).cuda()
    r64, rmx = chol_reg(M, 1e-4, 10, backend="f64"), chol_reg(M, 1e-4, 10, backend="mixed")
    print(f"phase 40d panel_chol_mixed n=128 cond 1e8: |Li L - I| {err:.1e}; chol_reg of an "
          f"indefinite n=160: shifts f64 {r64.shifts} mixed {rmx.shifts}", flush=True)
    check(err < 1e-11, "phase 40d panel inverse")
    check(r64.shifts == rmx.shifts > 0 and r64.ok and rmx.ok, "phase 40d chol_reg shifts")

    # ---- (e) the kit=1 materialized route under 'int8': theta1-cg's data is
    # dense (no rank-1 group), so a max-cut graph (rank-1, n = 200) takes it
    rng = np.random.default_rng(40)
    Wg = np.triu(rng.random((200, 200)) < 0.05, 1) * rng.integers(1, 10, (200, 200))
    p = maxcut_problem((Wg + Wg.T).astype(float), datarank=-1, device="cuda")
    check(p.groups[0].is_rank1, "phase 40e: max-cut data not rank-1")
    res = {}
    for backend, needs in (("f64", KIT1_NEEDS), ("int8", KIT1_NEEDS + OZAKI)):
        res[backend] = launches.run(f"phase 40e (max-cut N=200 kit=1 {backend})", needs,
                                    lambda: ltt.solve(p, dict(THETA1_CG, gemm_backend=backend),
                                                      device="cuda"))
        print(solve_line(f"40e max-cut N=200 kit=1 materialized gemm_backend={backend}",
                         res[backend]), flush=True)
        check(res[backend].status == 1, f"phase 40e {backend} not OPTIMAL")
    check(abs(res["int8"].iterations - res["f64"].iterations) <= 1, "phase 40e iterations")
    check(abs(res["int8"].objective - res["f64"].objective)
          <= 1e-6 * abs(res["f64"].objective), "phase 40e objective")
    print("phase 40e theta1-cg: dense data, no rank-1 group: gemm_backend='int8' leaves it "
          "as it is", flush=True)


@contextlib.contextmanager
def jacobi_regime(tj, regime: str):
    """The Jacobi wrappers take ``regime`` wherever they would take "grid"
    (the old kernel's trajectory beside the new one's)."""
    rule = tj.regime_for

    def forced(nb, mp, eigvecs, sms=tj.H100_SMS):
        got = rule(nb, mp, eigvecs, sms)
        return regime if got == "grid" else got

    tj.regime_for = forced
    try:
        yield
    finally:
        tj.regime_for = rule


def iteration_ms(r) -> str:
    return "[" + ", ".join(f"{1e3 * t:.2f}" for t in r.iteration_times) + "]"


def tori_phase(launches, ltt, tj) -> dict:
    """Phase 41: the toroidal max-cut graphs TORI through `maxcut_problem` on
    the card. Returns the grid regime's launches by kernel."""
    from loraine_tpu_torch.models.maxcut import maxcut_problem, torus_graph
    from loraine_tpu_torch.utils.diagnostics import profile_phases

    grid = {"B1": 0, "B2": 0}
    for rows, cols, seed in TORI:
        W = torus_graph(rows, cols, seed)
        n = W.shape[0]
        p = maxcut_problem(W, datarank=-1, device="cuda")
        label = f"41 torus {rows}x{cols} (n={n}, {int((W != 0).sum()) // 2} edges)"
        # (a) the default modes: B1 seeds the NT scaling, B2 bounds the steps
        r = launches.run(f"phase {label}", ("B1", "B2"),
                         lambda: ltt.solve(p, TORUS_OPTS, device="cuda"))
        by = launches.by_regime
        print(solve_line(label, r) + f" iter_ms={iteration_ms(r)} | TORI_REF (rounds): "
              f"{TORI_REF[n]}", flush=True)
        check((r.status_name, r.iterations, r.objective) == TORI_REF[n],
              f"phase {label}: the trajectory differs from TORI_REF's")
        check(by["B1"] == {"grid": r.iterations} and by["B2"] == {"grid": 2 * r.iterations},
              f"phase {label}: B1 {by['B1']} B2 {by['B2']}, not 1 and 2 an iteration in 'grid'")
        grid["B1"] += by["B1"]["grid"]
        grid["B2"] += by["B2"]["grid"]
        # (b) the old kernel on the same input, in the same call
        with jacobi_regime(tj, "rounds"):
            r_old = launches.run(f"phase {label} rounds", ("B1", "B2"),
                                 lambda: ltt.solve(p, TORUS_OPTS, device="cuda"))
        print(solve_line(f"{label} rounds", r_old) + f" iter_ms={iteration_ms(r_old)}", flush=True)
        check((r_old.status_name, r_old.iterations, r_old.objective)
              == (r.status_name, r.iterations, r.objective), f"phase {label}: rounds vs grid")
        # (c) the library's eigh for the NT scaling and the steps (no Jacobi
        # kernel), and (d) the same seed with B2's bounds for the steps
        lib = launches.run(f"phase {label} library eigh", (),
                           lambda: ltt.solve(p, dict(TORUS_OPTS, eigh_backend="mixed",
                                                     step_eig="exact"), device="cuda"))
        check_jacobi(launches, f"phase {label} library eigh", False, False)
        b2 = launches.run(f"phase {label} B2 steps", ("B2",),
                          lambda: ltt.solve(p, dict(TORUS_OPTS, eigh_backend="mixed",
                                                    step_eig="pallas"), device="cuda"))
        check_jacobi(launches, f"phase {label} B2 steps", False, True)
        check(launches.by_regime["B2"] == {"grid": 2 * b2.iterations},
              f"phase {label} B2 steps: {launches.by_regime['B2']}")
        grid["B2"] += launches.by_regime["B2"]["grid"]
        for name, x in (("library eigh (mixed, exact)", lib), ("B2 steps (mixed, pallas)", b2)):
            print(solve_line(f"{label} {name}", x), flush=True)
            check(x.status == 1, f"phase {label} {name} not OPTIMAL")
        check(abs(b2.objective - lib.objective) <= OBJ_RTOL * abs(lib.objective),
              f"phase {label}: B2 steps vs library eigh objective")
        # (e) one step's phases at the first iterate (the default modes)
        ph = profile_phases(p, TORUS_OPTS, repeats=2, iters=1)
        print(f"phase {label} profile_phases ms: "
              + " ".join(f"{k}={1e3 * v:.2f}" for k, v in ph.items()), flush=True)
    return grid


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
    from loraine_tpu_torch.ops import dd_linalg as dl, int8gemm as ti, jacobi as tj, pcg as tp
    from loraine_tpu_torch.utils.cuda_build import BUILD_DIR, build_libraries

    # ---- phase 1: setup + build
    print(f"phase 1 python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card '{card}' count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    build_libraries("jacobi", "pcg", "int8gemm", "dd_linalg")
    for mod in (tj, tp, ti, dl):
        mod._lib()
    print(f"phase 1 built+loaded csrc/jacobi.cu, csrc/pcg.cu, csrc/int8gemm.cu and "
          f"csrc/dd_linalg.cu in "
          f"{time.perf_counter() - t0:.2f} s into {BUILD_DIR}", flush=True)

    # ---- phase 2: Jacobi kernels vs plain versions on the card
    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else None
    k = kernels_vs_plain(tj, jacobi_library(parent) if parent else None)
    launches = Launches(tj, tp, ti, dl)

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
    thetag11_f64 = large_case(launches, "15", THETAG11, THETAG11_OPTS, THETAG11_REF, ltt)[0]
    check(launches.by_mp["B1"].get(816, 0) > 0, "thetaG11: B1 not launched at mp 816")

    # ---- phase 16: the solves went through all five kernels
    print("phase 16 launches in the solve phases: "
          + " ".join(f"{k_}={launches.total[k_]}" for k_ in KERNELS), flush=True)
    check(all(launches.total[k_] > 0 for k_ in KERNELS), "a kernel was not launched")

    # ---- phases 34-36 and 38(d), then 37 (after phase 19): the mesh, in a
    # thread beside phases 17-39
    mesh = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    mesh_done = [mesh.submit(timed, mesh_phases, f64_runs, maxg11_f64, card),
                 mesh.submit(timed, dd_steps_mesh, card)]

    # ---- phases 17-21: the precision tiers
    exactness_probe()
    phase19 = precision_tiers(launches, ltt, maxg11_f64)
    mesh_done.append(mesh.submit(timed, dd_mesh_phase, phase19, card))

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

    # ---- phases 38(a-c) and 39: the dd NT scaling, the examples
    t0 = time.perf_counter()
    nt_dd_phase(launches, ltt, phase19, card)
    print(f"phase 38(a-c) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    examples_phase()
    print(f"phase 39 took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mesh_s = [f.result() for f in mesh_done]
    mesh.shutdown()
    print(f"phases 34-36, 38(d) and 37 took {mesh_s[0]:.1f}, {mesh_s[1]:.1f} and {mesh_s[2]:.1f} s "
          f"beside phases 17-39 (then {time.perf_counter() - t0:.1f} s more)", flush=True)

    # ---- phase 40: gemm_backend='int8' (O1, O2) and chol_backend='mixed'
    t0 = time.perf_counter()
    ko = ozaki_vs_plain(ti)
    int8_mixed_phase(launches, ltt, maxg11_f64[0], thetag11_f64, f64_runs, card)
    print(f"phase 40 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 41: the 1000- and 2000-node tori, B1 and B2 in "grid"
    t0 = time.perf_counter()
    grid = tori_phase(launches, ltt, tj)
    print(f"phase 41 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 42: the dd NT scaling's kernels D1-D3, theta1 dd2 by default
    t0 = time.perf_counter()
    kd = dd_kernels_phase(launches, ltt, phase19, card)
    print(f"phase 42 took {time.perf_counter() - t0:.1f} s", flush=True)

    rows = []
    for key, kname, name, line in (
            ("eigh", "B1", "jacobi_eigh_f32", "jacobi_pallas.py:109"),
            ("bounds", "B2", "jacobi_bounds_f32", "jacobi_pallas.py:185"),
            ("eigh_grid", "B1", "jacobi_eigh_f32 (grid)", "jacobi_pallas.py:109"),
            ("bounds_grid", "B2", "jacobi_bounds_f32 (grid)", "jacobi_pallas.py:185")):
        ms, plain_ms, lib_ms, bnd, bound_by, regime = k["times"][key]
        rows.append({
            "name": name, "route": "cuda", "source": "loraine_tpu_torch/csrc/jacobi.cu",
            "replaces": f"loraine_tpu/ops/{line}",
            # the grid rows: the launches in "grid" of phase 41's solves
            "launches": grid[kname] if key.endswith("grid") else launches.total[kname],
            "max_abs_err": k["err"][key.removesuffix("_grid")],
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
    for kname, name, line in (("O1", "ozaki_slice_s8", "int8gemm.py:41"),
                              ("O2", "ozaki_gemm_s8", "int8gemm.py:70")):
        t = ko[kname]  # maxG11's shape
        rows.append({
            "name": name, "route": "cuda", "source": "loraine_tpu_torch/csrc/int8gemm.cu",
            "replaces": f"loraine_tpu/ops/{line}", "launches": launches.total[kname],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"],
        })
    for kname, name, line in (("D1", "dd_jacobi", "dd_linalg.py:281"),
                              ("D2", "dd_chol", "dd_linalg.py:162"),
                              ("D3", "dd_gemm", "dd_linalg.py:145")):
        t = kd[kname]  # theta1's (1, 56): phase 19's last iterate, phase 42(b)'s launches
        rows.append({
            "name": name, "route": "cuda", "source": "loraine_tpu_torch/csrc/dd_linalg.cu",
            "replaces": f"loraine_tpu/ops/{line}", "launches": t["launches"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "kernel_ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": t["shape"],
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
