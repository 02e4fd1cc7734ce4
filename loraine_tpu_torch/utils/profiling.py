"""Where an IPM iteration spends its time on the card.

Run from the root of a checkout on a CUDA machine:

    python3 -m loraine_tpu_torch.utils.profiling [CASE ...] [--out FILE]

CASE is one of tru9, vib9, thetaG11, maxG11 (default: the first three).
For each case, on the card: the problem load; one warm solve (kernel build,
cuBLAS handles) and two timed solves; one solve with the step's phase
functions wrapped in `torch.cuda.synchronize()` (ms per iteration of each;
the syncs inflate the total); and a `torch.profiler` trace of two warm steps
from the iterate halfway through the solve: the device kernels' time over
the traced wall (busy share), the top kernels, the device time and launches
of the kernels of csrc/jacobi.cu (their share of device time), and the
Jacobi wrappers' calls per padded size mp and per regime. Prints the card's
name and power limit, then one JSON line per case; ``--out`` also writes all
of them to FILE.
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
from loraine_tpu_torch.ops import jacobi as tj

# bench.py:80-83 (tru9, vib9), :86-87 (thetaG11) and maxG11's rank-1 options
KIT0 = {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "verb": 0}
CASES = {
    "tru9": ("tests/data/tru9.dat-s", KIT0),
    "vib9": ("tests/data/vib9.dat-s", KIT0),
    "thetaG11": ("tests/data/thetaG11.dat-s", dict(KIT0, datarank=-1)),
    "maxG11": ("tests/data/maxG11.dat-s", dict(KIT0, datarank=-1)),
}
# the functions `ipm/step.py` imports that the synced run times
PHASES = ("nt_scale", "eig_bounds_jacobi", "schur_group", "schur_lp", "chol_reg", "tri_inv",
          "Aop", "Aadj")
# the device kernels of csrc/jacobi.cu, as the trace names them
JACOBI_KERNELS = ("sm_kernel<", "cluster_kernel<", "round_kernel", "gersh_kernel",
                  "identity_kernel", "diag_kernel")


def synced_phases(problem, opts):
    """(ms per iteration of each phase, ms per iteration of the solve), with
    every phase call wrapped in device syncs."""
    acc = dict.fromkeys(PHASES, 0.0)
    orig = {k: getattr(S, k) for k in PHASES}

    def wrap(name, f):
        def g(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **kw)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            return out
        return g

    for k in PHASES:
        setattr(S, k, wrap(k, orig[k]))
    try:
        r = ltt.solve(problem, opts, device="cuda")
    finally:
        for k in PHASES:
            setattr(S, k, orig[k])
    it = r.iterations
    return {k: 1e3 * v / it for k, v in acc.items()}, 1e3 * r.solve_time / it


def traced(problem, opts, state, steps: int = 2):
    """torch.profiler trace of ``steps`` warm steps from ``state``."""
    o = ltt.Options.from_dict(opts).validated()
    S.step(problem, state, o)  # warm
    torch.cuda.synchronize()
    for fn in (tj.jacobi_eigh_cuda, tj.jacobi_bounds_cuda):
        fn.launches_by_mp.clear()
        fn.launches_by_regime.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        st = state
        for _ in range(steps):
            st, _ = S.step(problem, st, o)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    busy = sum(r[1] for r in rows)
    jac = [r for r in rows if any(k in r[0] for k in JACOBI_KERNELS)]
    jac_ms = sum(r[1] for r in jac)
    return {"steps": steps, "wall_ms": 1e3 * wall, "device_ms": busy,
            "busy_share": busy / (1e3 * wall), "top": rows[:14],
            "jacobi_device_ms": jac_ms, "jacobi_share": jac_ms / busy if busy else None,
            "jacobi_kernel_launches": sum(r[2] for r in jac),
            "jacobi_launches_by_mp": {
                "B1": dict(tj.jacobi_eigh_cuda.launches_by_mp),
                "B2": dict(tj.jacobi_bounds_cuda.launches_by_mp)},
            "jacobi_launches_by_regime": {
                "B1": dict(tj.jacobi_eigh_cuda.launches_by_regime),
                "B2": dict(tj.jacobi_bounds_cuda.launches_by_regime)}}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them; raises
    where nvidia-smi fails, so that no number goes out without them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def profile_case(path: str, opts) -> dict:
    t0 = time.perf_counter()
    p = ltt.load_problem(path, opts, device="cuda")
    load_s = time.perf_counter() - t0
    r = ltt.solve(p, opts, device="cuda")  # warm
    runs = [ltt.solve(p, opts, device="cuda") for _ in range(2)]
    phases, ms_it = synced_phases(p, opts)
    mid = ltt.solve(p, dict(opts, maxit=r.iterations // 2), device="cuda").final_state
    return {
        "load_s": load_s, "iterations": r.iterations, "objective": r.objective,
        "solve_s": [x.solve_time for x in runs],
        "median_iter_ms": [1e3 * float(np.median(x.iteration_times)) for x in runs],
        "synced_phase_ms_per_iter": phases, "synced_ms_per_iter": ms_it,
        "trace": traced(p, opts, mid),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", metavar="CASE", help=f"one of {', '.join(CASES)}")
    ap.add_argument("--out", help="write the results of all cases to this JSON file")
    args = ap.parse_args(argv)
    cases = args.cases or ["tru9", "vib9", "thetaG11"]
    unknown = sorted(set(cases) - set(CASES))
    if unknown:
        ap.error(f"unknown case(s) {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    out = {"card": card()}
    print("card", out["card"], flush=True)
    for name in cases:
        out[name] = profile_case(*CASES[name])
        print(name, json.dumps(out[name], default=str), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
