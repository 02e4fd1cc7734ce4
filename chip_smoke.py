#!/usr/bin/env python3
"""Smoke test of loraine_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and no network, and exits non-zero on the first failed check.

Phases:
  1. setup: card name and power limit, build of the CUDA Jacobi kernels
     (csrc/jacobi.cu, nvcc for sm_90a) from the checkout.
  2. each kernel against its plain PyTorch version on the card, at the
     solver's shapes (nb, m) in {(1, 56), (2, 56), (1, 800), (2, 800)}, on
     clustered (IPM-like) and random spectra, with both times.
  3. SDPLIB theta1 (n=104, one 50x50 block) through ``solve_sdpa`` on the
     card: OPTIMAL at 23.0, and the same trajectory as the CPU run of the
     port (plain Jacobi versions) on the same input.
  4. SDPLIB maxG11 (n=800, one 800x800 block, rank-1 data) through
     ``solve_sdpa`` on the card: OPTIMAL at 629.1648.
  5. kernel launch counts of phases 3-4 (reset just before them).

The line before the last two is a JSON object with one entry per kernel;
then the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

THETA1 = "tests/data/theta1.dat-s"
MAXG11 = "tests/data/maxG11.dat-s"
THETA1_OPT = 23.0  # SDPLIB optimum
MAXG11_OPT = 629.1648  # SDPLIB optimum
OBJ_RTOL = 1e-5
SHAPES = [(1, 56), (2, 56), (1, 800), (2, 800)]


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


def seed_quality(A, lam, V, scale):
    """(max reconstruction error / scale, max orthogonality error) of an f32
    eigenpair seed, in f64."""
    Vd = V.double()
    recon = ((Vd * lam.double()[:, None, :]) @ Vd.mT - A).abs().amax((-1, -2)) / scale
    eye = torch.eye(V.shape[-1], dtype=Vd.dtype, device=Vd.device)
    return float(recon.max()), float((Vd.mT @ Vd - eye).abs().max())


def kernels_vs_plain(tj) -> dict:
    """Phase 2. Returns per-kernel max errors and the times at the maxG11
    shapes: B1 (1, 800), B2 (2, 800)."""
    err = {"eigh": 0.0, "bounds": 0.0}
    times = {}
    for nb, m in SHAPES:
        for kind in ("clustered", "random"):
            A = torch.from_numpy(spectrum_matrix(kind, m, nb, seed=1000 * nb + m)).cuda()
            Mn, scale = tj._normalize_pad(A)
            s1, s2 = tj.jacobi_sweeps_for(m), tj.bound_sweeps_for(m)
            lam_k, V_k = tj._sorted_eigh(*tj.jacobi_eigh_cuda(Mn, s1), m, scale)
            lam_p, V_p = tj._sorted_eigh(*tj.jacobi_eigh_plain(Mn, s1), m, scale)
            lo_k, hi_k = tj._widened_bounds(*tj.jacobi_bounds_cuda(Mn, s2), m, scale, A.dtype)
            lo_p, hi_p = tj._widened_bounds(*tj.jacobi_bounds_plain(Mn, s2), m, scale, A.dtype)
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
            # the plain versions already ran once above (warm)
            pms_e = cuda_ms(lambda: tj.jacobi_eigh_plain(Mn, s1), 1, warmup=False)
            pms_b = cuda_ms(lambda: tj.jacobi_bounds_plain(Mn, s2), 1, warmup=False)
            print(
                f"phase 2 nb={nb} m={m} {kind}: B1 sweeps={s1} |lam-plain|/scale={e_plain:.2e} "
                f"|lam-f64|/scale={e_f64:.2e} recon={recon:.2e} (plain {recon_p:.2e}) "
                f"orth={orth:.2e} (plain {orth_p:.2e}) ms={ms_e:.3f} plain_ms={pms_e:.1f} | "
                f"B2 sweeps={s2} |bound-plain|/scale={b_plain:.2e} slack/scale={slack:.2e} "
                f"(plain {slack_p:.2e}) valid={valid} ms={ms_b:.3f} plain_ms={pms_b:.1f}",
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
                times["eigh"] = (ms_e, pms_e)
            if kind == "clustered" and (nb, m) == (2, 800):
                times["bounds"] = (ms_b, pms_b)
    return {"err": err, "times": times}


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
    from loraine_tpu_torch.ops import jacobi as tj
    from loraine_tpu_torch.utils.cuda_build import BUILD_DIR

    # ---- phase 1: setup + build
    print(f"phase 1 python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card '{card}' count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    tj._lib()
    print(f"phase 1 built+loaded csrc/jacobi.cu in {time.perf_counter() - t0:.2f} s "
          f"into {BUILD_DIR}", flush=True)

    # ---- phase 2: kernels vs plain versions on the card
    k = kernels_vs_plain(tj)

    # ---- phase 3: theta1, card against the port's CPU run
    opts = {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0}
    ref = ltt.solve_sdpa(THETA1, opts, device="cpu")
    tj.jacobi_eigh_cuda.launches = 0
    tj.jacobi_bounds_cuda.launches = 0
    r = ltt.solve_sdpa(THETA1, opts, device="cuda")
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
    r = ltt.solve_sdpa(MAXG11, opts, device="cuda")
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

    # ---- phase 5: the main path went through both kernels
    launches = {"eigh": tj.jacobi_eigh_cuda.launches, "bounds": tj.jacobi_bounds_cuda.launches}
    print(f"phase 5 launches in phases 3-4: B1={launches['eigh']} B2={launches['bounds']}", flush=True)
    check(launches["eigh"] > 0 and launches["bounds"] > 0, "a kernel was not launched")

    rows = []
    for key, name, line in (("eigh", "jacobi_eigh_f32", 109), ("bounds", "jacobi_bounds_f32", 185)):
        ms, plain_ms = k["times"][key]
        rows.append({
            "name": name, "route": "cuda", "source": "loraine_tpu_torch/csrc/jacobi.cu",
            "replaces": f"loraine_tpu/ops/jacobi_pallas.py:{line}",
            "launches": launches[key], "max_abs_err": k["err"][key],
            "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
