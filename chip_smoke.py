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
     ``solve_sdpa`` on the card: OPTIMAL at 629.1648.
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

The reference values of phases 11, 12 and 15 are the JAX package's CPU
runs (`benchmarks/results_cpu_r2.jsonl`). Every solve (phases 3, 4, 7-13,
15) runs with the launch counts set to 0 just before it and read just
after, and fails if a kernel of its path was not launched. The line before
the last two is a JSON object with one entry per kernel; then the card's
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
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
KERNELS = ("B1", "B2", "B3", "B4", "polish")
# the kernels of the kit=1 materialized route (B3 and the polish after it)
KIT1_NEEDS = ("B1", "B2", "B3", "polish")


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
        per_it = " ".join(f"{k}={v / r.iterations:.2f}" for k, v in got.items())
        print(f"launches in {label}: " + " ".join(f"{k}={v}" for k, v in got.items())
              + f" | by mp: B1 {self.by_mp['B1']} B2 {self.by_mp['B2']}"
              + " | by regime: " + " ".join(f"{k} {v}" for k, v in self.by_regime.items() if v)
              + f" | per iteration ({r.iterations}): {per_it}", flush=True)
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


def large_case(launches, phase: str, path: str, opts, ref, ltt, problem=None):
    """One full-size solve on the card against the JAX package's CPU
    reference (objective within OBJ_RTOL, iterations within 2); prints the
    wall time, the median time per iteration and the peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if problem is None:
        r = launches.run(f"phase {phase}", ("B1", "B2"),
                         lambda: ltt.solve_sdpa(path, opts, device="cuda"))
    else:
        r = launches.run(f"phase {phase}", ("B1", "B2"),
                         lambda: ltt.solve(problem, opts, device="cuda"))
    wall = time.perf_counter() - t0
    print(solve_line(f"{phase} {path.split('/')[-1]} cuda", r)
          + f" wall(load+solve)={wall:.3f} s "
          f"peak_mem_MiB={torch.cuda.max_memory_allocated() / 2**20:.1f} "
          f"| JAX CPU: obj={ref[0]} it={ref[1]}", flush=True)
    name = path.split("/")[-1]
    check(r.status == 1, f"{name} not OPTIMAL")
    check(abs(r.objective - ref[0]) <= OBJ_RTOL * abs(ref[0]), f"{name} objective")
    check(abs(r.iterations - ref[1]) <= 2, f"{name} iterations")
    check(math.isfinite(r.dimacs) and r.dimacs < opts["eDIMACS"], f"{name} DIMACS")
    check(all(bool(np.isfinite(X).all()) for X in r.X), f"{name} primal blocks")
    return r


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
    opts = {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0}
    ref = ltt.solve_sdpa(THETA1, opts, device="cpu")
    r = launches.run("phase 3", ("B1", "B2"), lambda: ltt.solve_sdpa(THETA1, opts, device="cuda"))
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

    # ---- phase 4: maxG11 at full size
    opts = {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "datarank": -1, "verb": 0}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = launches.run("phase 4", ("B1", "B2"), lambda: ltt.solve_sdpa(MAXG11, opts, device="cuda"))
    wall = time.perf_counter() - t0
    X = r.X[0]
    print(f"phase 4 maxG11 cuda: {r.status_name} obj={r.objective!r} it={r.iterations} "
          f"wall(load+solve)={wall:.3f} s solve={r.solve_time:.3f} s "
          f"it/s={r.iterations / r.solve_time:.3f} "
          f"median_iter_ms={1e3 * float(np.median(r.iteration_times)):.2f} dimacs={r.dimacs:.3e} "
          f"peak_mem_MiB={torch.cuda.max_memory_allocated() / 2**20:.1f}", flush=True)
    check(r.status == 1, "maxG11 not OPTIMAL")
    check(abs(r.objective - MAXG11_OPT) <= OBJ_RTOL * MAXG11_OPT, "maxG11 objective")
    check(X.shape == (800, 800) and bool(np.isfinite(X).all()), "maxG11 primal block")
    check(math.isfinite(r.dimacs) and r.dimacs < opts["eDIMACS"], "maxG11 DIMACS")

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
    large_case(launches, "11", TRU9, LARGE_KIT0, TRU9_REF, ltt)

    # ---- phase 12: vib9 at full size, two block groups
    p = ltt.load_problem(VIB9, LARGE_KIT0, device="cuda")
    groups = [(g.m, g.nb, g.is_sparse) for g in p.groups]
    print(f"phase 12 vib9 groups (m, nb, sparse): {groups} nlin={p.nlin}", flush=True)
    check(groups == [(144, 1, True), (152, 1, True)] and p.nlin == 6480, "vib9 block groups")
    large_case(launches, "12", VIB9, LARGE_KIT0, VIB9_REF, ltt, problem=p)
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
