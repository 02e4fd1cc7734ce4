"""Where an IPM iteration spends its time on the card.

Run from the root of a checkout on a CUDA machine:

    python3 -m loraine_tpu_torch.utils.profiling [CASE ...] [--out FILE]
    python3 -m loraine_tpu_torch.utils.profiling --quick CASE ... [--out FILE]
    python3 -m loraine_tpu_torch.utils.profiling --once [--plain-b1] CASE ...

CASE is one of tru9, vib9, thetaG11, maxG11, theta1 (kit=0), control1-cg,
theta_G100, theta1-cg (kit=1, the materialized CG route), tru9-cg, vib9-cg (kit=1 with
control1-cg's options, the matrix-free route at n = 3240), and the precision
tiers theta1-dd, theta1-dd2, tru3-sparse, tru3-sparse-dd2, lp, lp-dd2,
theta1-cg-dd, theta1-cg-dd2, maxG11-dd (`chip_smoke.py` phases 18-21's
options; on the card kit=0 'dd2' takes the dd NT scaling by default) and
theta1-dd2-f64nt (theta1-dd2 under nt_precision='f64'); default: tru9,
vib9, thetaG11.
For each case, on the card: the problem load; one warm solve (kernel build,
cuBLAS handles) and two timed solves; and a `torch.profiler` trace of two
warm steps from the iterate halfway through the solve: the device kernels'
time over the traced wall (busy share), the device ms a step of each of
the step's phase spans (``ltt.step`` around each step and the spans inside
it, `ipm/step.py`; a span's time includes its children's), the top
kernels, the device time and launches of the kernels of csrc/jacobi.cu, of
csrc/pcg.cu (their shares of device time, and those of B3, B4 and the
polish apart) and of csrc/dd_linalg.cu (D1-D3), the wrappers' calls per
padded size mp and per regime, and the device kernels launched per step.
Prints the card's name and power limit, then one JSON line per case;
``--out`` also writes all of them to FILE. ``--quick`` times one solve
after the warm one (for the slow precision-tier cases).

``--once`` solves each case once and prints its status, objective,
iterations, CG iterations, solve time and median time per iteration; with
``--plain-b1`` the Jacobi seed B1 runs its plain PyTorch version on the
card instead of the kernel (B2 stays the kernel), to tell whether a
trajectory's difference comes from the seed's rounding.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

import loraine_tpu_torch as ltt
import loraine_tpu_torch.ipm.step as S
from loraine_tpu_torch.ops import jacobi as tj, pcg as tp
from loraine_tpu_torch.utils.timers import PREFIX, span

# bench.py:80-83 (tru9, vib9), :86-87 (thetaG11) and maxG11's rank-1 options
KIT0 = {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "verb": 0}
# bench.py:77-79 (control1-cg) and :93-95 (theta1-cg, also theta_G100's)
CONTROL1_CG = {"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-6,
               "initpoint": 1, "verb": 0}
THETA1_CG = {"kit": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-5, "preconditioner": 1,
             "initpoint": 1, "verb": 0}


def lp_synthetic(device="cuda"):
    """The mixed PSD + LP problem of tests/test_precision.py:76-96 (seed 5)."""
    rng = np.random.default_rng(5)
    n, m = 6, 5
    A = rng.standard_normal((n, m, m))
    A = (A + A.transpose(0, 2, 1)) / 2
    b = rng.standard_normal(n) * 0.1
    C_lin = rng.standard_normal((n, 4))
    d_lin = np.abs(rng.standard_normal(4)) + 1.0
    return ltt.problem_from_dense([A], [np.eye(m)], b, C_lin=C_lin, d_lin=d_lin,
                                  storage="dense", device=device)


def dd_nt_case(device="cuda"):
    """The problem of tests/test_precision.py::test_dd_nt_e2e_cpu: one dense
    8x8 block, n = 10, seed 5 (the native dd NT scaling's end-to-end case)."""
    rng = np.random.default_rng(5)
    m, n = 8, 10
    A = rng.standard_normal((n, m, m))
    A = (A + A.transpose(0, 2, 1)) / 2
    C = rng.standard_normal((m, m))
    C = C @ C.T + m * np.eye(m)
    return ltt.problem_from_dense([A], [C], np.einsum("jpp->j", A), storage="dense",
                                  device=device)


def tru3_sparse(device="cuda"):
    """SDPLIB tru3 forced to sparse storage (tests/test_precision.py:158-160)."""
    return ltt.problem_from_sdpa("tests/data/tru3.dat-s", storage="sparse", device=device)


def theta_g100(device="cuda"):
    """Lovasz theta SDP at SDPLIB theta2's size: 100 vertices, edges with
    probability 0.1 from seed 2 (463 edges), n = 464, dense storage
    (`loraine_tpu.models.theta.lovasz_theta_problem` builds the same data)."""
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


THETA1 = "tests/data/theta1.dat-s"
# the precision tiers: tests/test_precision.py's options (chip_smoke.py
# phases 18-21); the f64 rows beside them at the f64 solver's eDIMACS
THETA1_KIT0 = {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0}
DD = {"kit": 0, "eDIMACS": 1e-11, "initpoint": 1, "verb": 0, "precision": "dd", "maxit": 30}
DD2 = dict(DD, eDIMACS=5e-13, precision="dd2", datasparsity=0)
CG_DD = {"precision": "dd", "kit": 1, "preconditioner": 1, "eDIMACS": 1e-9, "tol_cg_min": 1e-9,
         "initpoint": 1, "verb": 0, "maxit": 40}
CG_DD2 = dict(CG_DD, precision="dd2", eDIMACS=1e-10, tol_cg_min=1e-10, datasparsity=0)
# the native dd NT scaling end to end (tests/test_precision.py::test_dd_nt_e2e_cpu;
# `chip_smoke.py` phase 38)
DD2_NT = {"kit": 0, "eDIMACS": 1e-12, "verb": 0, "precision": "dd2", "nt_precision": "dd",
          "maxit": 40}

# name -> (SDPA file or a function of the device that builds the problem, options)
CASES = {
    "tru9": ("tests/data/tru9.dat-s", KIT0),
    "vib9": ("tests/data/vib9.dat-s", KIT0),
    "thetaG11": ("tests/data/thetaG11.dat-s", dict(KIT0, datarank=-1)),
    "maxG11": ("tests/data/maxG11.dat-s", dict(KIT0, datarank=-1)),
    "theta1": (THETA1, THETA1_KIT0),
    "control1-cg": ("tests/data/control1.dat-s", CONTROL1_CG),
    "theta_G100": (theta_g100, THETA1_CG),
    "theta1-cg": (THETA1, THETA1_CG),
    # verb=1: the iteration log shows how far a solve got if a time limit
    # stops it
    "tru9-cg": ("tests/data/tru9.dat-s", dict(CONTROL1_CG, verb=1)),
    "vib9-cg": ("tests/data/vib9.dat-s", dict(CONTROL1_CG, verb=1)),
    "theta1-dd": (THETA1, DD),
    "theta1-dd2": (THETA1, DD2),
    "theta1-dd2-f64nt": (THETA1, dict(DD2, nt_precision="f64")),
    "tru3-sparse": (tru3_sparse, dict(KIT0, eDIMACS=1e-7)),
    "tru3-sparse-dd2": (tru3_sparse, {"kit": 0, "eDIMACS": 1e-9, "initpoint": 1, "verb": 0,
                                       "precision": "dd2"}),
    "lp": (lp_synthetic, {"eDIMACS": 1e-7, "verb": 0}),
    "lp-dd2": (lp_synthetic, {"eDIMACS": 1e-13, "verb": 0, "precision": "dd2", "maxit": 40}),
    "theta1-cg-dd": (THETA1, CG_DD),
    "theta1-cg-dd2": (THETA1, CG_DD2),
    "maxG11-dd": ("tests/data/maxG11.dat-s", dict(KIT0, datarank=-1, eDIMACS=1e-8,
                                                  precision="dd")),
}
# the device kernels of csrc/jacobi.cu and csrc/pcg.cu, as the trace names them
JACOBI_KERNELS = ("sm_kernel<", "cluster_kernel<", "round_kernel", "gersh_kernel",
                  "identity_kernel", "diag_kernel")
PCG_KERNELS = ("cg_kernel<", "cg_block_kernel<", "cg_cluster_kernel<")
# the device kernels of csrc/dd_linalg.cu (D1, D2, D3)
DD_KERNELS = ("dd_jacobi_kernel<", "dd_chol_kernel(", "dd_chol_global_kernel",
              "dd_gemm_kernel")
# B3, B4 and the polish are instantiations of one template (type, MINRES):
# the trace tells them apart by its arguments
PCG_ARGS = {"B3": "<double, true>", "B4": "<float, false>", "polish": "<double, false>"}


def device_rows(prof):
    """(name, device ms, count) of the device kernels in a trace."""
    rows, allrows = [], []
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt > 0:
            allrows.append((e.key, dt / 1e3, e.count))
            # device kernels only: the CPU-side aten:: entries report their
            # kernels' time again
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
                rows.append(allrows[-1])
    if not rows:
        rows = [r for r in allrows if not r[0].startswith(("aten::", "cuda"))]
    rows.sort(key=lambda x: -x[1])
    return rows


def span_rows(prof, steps: int):
    """Device ms a step and calls a step of each ``ltt.`` span in a trace
    (a span's device time includes its children's)."""
    out = {}
    for e in prof.key_averages():
        if e.key.startswith(PREFIX):
            dt = getattr(e, "device_time_total", None)
            if dt is None:
                dt = getattr(e, "cuda_time_total", 0.0)
            out[e.key] = {"device_ms": dt / 1e3 / steps, "calls": e.count / steps}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_ms"]))


def _share(rows, names, busy):
    """(device ms, share of the busy time, launches) of the kernels named."""
    mine = [r for r in rows if any(k in r[0] for k in names)]
    ms = sum(r[1] for r in mine)
    return ms, (ms / busy if busy else None), sum(r[2] for r in mine)


def _cg_wrappers():
    """The CG kernels' wrappers of this version of `ops/pcg.py`."""
    return {k: getattr(tp, f) for k, f in (("B3", "cg_minres_f64_cuda"), ("B4", "cg_f32_cuda"),
                                           ("polish", "cg_f64_cuda")) if hasattr(tp, f)}


def traced(problem, opts, state, done: int, steps: int = 2):
    """torch.profiler trace of ``steps`` warm steps from ``state``, the
    iterate after ``done`` iterations (kit=1: with the solver's CG tolerance
    of that iteration)."""
    o = ltt.Options.from_dict(opts).validated()
    kw = {}
    if o.kit == 1:
        kw = {"tol_cg": max(o.tol_cg * o.tol_cg_up ** done, o.tol_cg_min),
              "precond_kind": o.preconditioner}
    S.step(problem, state, o, **kw)  # warm
    torch.cuda.synchronize()
    for fn in (tj.jacobi_eigh_cuda, tj.jacobi_bounds_cuda):
        fn.launches_by_mp.clear()
        fn.launches_by_regime.clear()
    cg = _cg_wrappers()
    for fn in cg.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_regime"):
            fn.launches_by_regime.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        st = state
        for _ in range(steps):
            with span("step"):
                st, _ = S.step(problem, st, o, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    launched = sum(r[2] for r in rows)
    jac_ms, jac_share, jac_n = _share(rows, JACOBI_KERNELS, busy)
    cg_ms, cg_share, cg_n = _share(rows, PCG_KERNELS, busy)
    cg_rows = [r for r in rows if any(k in r[0] for k in PCG_KERNELS)]
    dd_ms, dd_share, dd_n = _share(rows, DD_KERNELS, busy)
    return {"steps": steps, "wall_ms": 1e3 * wall, "device_ms": busy,
            "busy_share": busy / (1e3 * wall), "device_launches_per_step": launched / steps,
            "spans": span_rows(prof, steps),
            "top": rows[:14],
            "jacobi_device_ms": jac_ms, "jacobi_share": jac_share,
            "jacobi_kernel_launches": jac_n,
            "jacobi_launches_by_mp": {
                "B1": dict(tj.jacobi_eigh_cuda.launches_by_mp),
                "B2": dict(tj.jacobi_bounds_cuda.launches_by_mp)},
            "jacobi_launches_by_regime": {
                "B1": dict(tj.jacobi_eigh_cuda.launches_by_regime),
                "B2": dict(tj.jacobi_bounds_cuda.launches_by_regime)},
            "pcg_device_ms": cg_ms, "pcg_share": cg_share, "pcg_kernel_launches": cg_n,
            "pcg_share_by_kernel": {k: _share(cg_rows, (a,), busy)[1] for k, a in PCG_ARGS.items()},
            "pcg_launches": {k: fn.launches for k, fn in cg.items()},
            "pcg_launches_by_regime": {k: dict(getattr(fn, "launches_by_regime", {}))
                                       for k, fn in cg.items()},
            "dd_device_ms": dd_ms, "dd_share": dd_share, "dd_kernel_launches": dd_n}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them; raises
    where nvidia-smi fails, so that no number goes out without them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _load(src, opts):
    return src("cuda") if callable(src) else ltt.load_problem(src, opts, device="cuda")


def solve_once(name: str, src, opts) -> dict:
    """One solve of a case on the card (``--once``)."""
    p = _load(src, opts)
    torch.cuda.reset_peak_memory_stats()
    r = ltt.solve(p, opts, device="cuda")
    return {"case": name, "status": r.status_name, "objective": r.objective,
            "iterations": r.iterations, "cg_iterations": r.cg_iterations, "dimacs": r.dimacs,
            "solve_s": r.solve_time,
            "median_iter_ms": 1e3 * float(np.median(r.iteration_times)),
            "peak_mem_MiB": torch.cuda.max_memory_allocated() / 2**20}


def profile_case(src, opts, quick: bool = False) -> dict:
    t0 = time.perf_counter()
    p = _load(src, opts)
    load_s = time.perf_counter() - t0
    r = ltt.solve(p, opts, device="cuda")  # warm
    runs = [ltt.solve(p, opts, device="cuda") for _ in range(1 if quick else 2)]
    done = r.iterations // 2
    mid = ltt.solve(p, dict(opts, maxit=done), device="cuda").final_state
    return {
        "load_s": load_s, "iterations": r.iterations, "objective": r.objective,
        "cg_iterations": r.cg_iterations,
        "solve_s": [x.solve_time for x in runs],
        "median_iter_ms": [1e3 * float(np.median(x.iteration_times)) for x in runs],
        "trace": traced(p, opts, mid, done),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", metavar="CASE", help=f"one of {', '.join(CASES)}")
    ap.add_argument("--out", help="write the results of all cases to this JSON file")
    ap.add_argument("--once", action="store_true", help="one solve per case, no profile")
    ap.add_argument("--quick", action="store_true",
                    help="one timed solve after the warm one")
    ap.add_argument("--plain-b1", action="store_true",
                    help="with --once: B1's plain version on the card instead of the kernel")
    args = ap.parse_args(argv)
    cases = args.cases or ["tru9", "vib9", "thetaG11"]
    unknown = sorted(set(cases) - set(CASES))
    if unknown:
        ap.error(f"unknown case(s) {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    out = {"card": card()}
    print("card", out["card"], flush=True)
    if args.plain_b1:
        # `jacobi_eigh_padded` looks the kernel's wrapper up at each call
        tj.jacobi_eigh_cuda = tj.jacobi_eigh_plain
    for name in cases:
        out[name] = (solve_once(name, *CASES[name]) if args.once
                     else profile_case(*CASES[name], quick=args.quick))
        print(name, json.dumps(out[name], default=str), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
