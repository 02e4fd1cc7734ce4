"""The iterates of a toroidal max-cut solve's first steps, with the NT
scaling's verdict on each, written out so that another implementation can
scale the same iterates.

Run from the root of a checkout:

    python3 -m loraine_tpu_torch.utils.iterates ROWS COLS SEED --steps K --out FILE.npz

Builds the rows x cols torus of `models.maxcut.torus_graph`, takes K IPM
steps from the initial point under maxG11's options (kit=0, datarank=-1,
eDIMACS 1e-5, the default modes) and, at each iterate k = 0..K, runs the NT
scaling (`ops.nt_scaling.nt_scale`) on X_k, S_k with the step's eigensolver
('auto': the B1 seed refined by `eigh_mixed`) and with the library's f32
seed ('mixed'). It prints one JSON line per iterate: both verdicts, the
smallest and largest eigenvalue of M = Lx^T S Lx in f64 and the smallest
one that `eigh_mixed` on the B1 seed returned. It stops at the first
iterate whose scaling fails under 'auto'; FILE gets X_k and S_k (f64) of
the last iterate, with the graph's arguments.
``--device cpu`` runs the plain versions of the kernels (small tori
only).

Given an SDPA file instead (for the benchmark's requests, the file that
``python3 sdpbench/plain_step.py request`` writes: a configuration's
instance relabeled by the benchmark's (seed, k)), it solves it under the
same options as the benchmark's timed path does (``problem_from_sdpa``,
then `Solver`; maxG11's options are thetaG11's) and
redoes the steps of the iterations AT (1-based, ``last`` for the last)
from their iterates with the step's NT scaling, Schur matrix and corrector
directions recorded:

    python3 -m loraine_tpu_torch.utils.iterates --sdpa FILE.dat-s --at 1,8,last --out FILE.npz

FILE.npz gets, for each such iteration k, the iterate X_k, S_k of block 0
(unpadded), the scaling W_k, the Schur matrix H_k, the corrector's
directions dX_k, dS_k and its steplengths alpha_k, beta_k, which
``python3 sdpbench/plain_step.py compare FILE.npz`` holds against the
benchmark's plain reference.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

OPTS = {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "datarank": -1, "verb": 0}


def scale_iterates(rows: int, cols: int, seed: int, steps: int, device: str = "cuda"):
    """[(record, X_k, S_k)] for k = 0..steps (see the module docstring);
    stops after the first iterate whose scaling fails under 'auto'."""
    from ..config import Options
    from ..ipm.initial import initial_point
    from ..ipm.step import step
    from ..models.maxcut import maxcut_problem, torus_graph
    from ..ops.eigh import eigh_mixed
    from ..ops.linalg import chol_reg
    from ..ops.nt_scaling import nt_scale

    p = maxcut_problem(torus_graph(rows, cols, seed), datarank=-1, device=device)
    o = Options.from_dict(OPTS).validated()
    st = initial_point(p, o)
    out = []
    for k in range(steps + 1):
        X, S = st.X[0], st.S[0]
        Lx = chol_reg(X, 1e-5, 1000).L
        M = Lx.mT @ S @ Lx
        M = (M + M.mT) / 2
        ev = torch.linalg.eigvalsh(M)
        rec = {"k": k, "n": X.shape[-1], "M_eig_min": float(ev[0, 0]),
               "M_eig_max": float(ev[0, -1])}
        for backend in (o.eigh_backend, "mixed"):
            rec[f"nt_ok_{backend}"] = bool(nt_scale(X, S, eigh_backend=backend).ok)
        lam, _ = eigh_mixed(M, seed="pallas")  # what the scaling under 'auto' sees
        rec["eigh_mixed_min"] = float(lam[0, 0])
        out.append((rec, X.cpu().numpy(), S.cpu().numpy()))
        if not rec[f"nt_ok_{o.eigh_backend}"] or k == steps:
            break
        st, _ = step(p, st, o)
    return out


def capture_step(problem, state, opts, *args, **kwargs) -> dict:
    """One step from ``state`` (`ipm.step.step`'s arguments after the
    state) with the NT scaling, the Schur matrix and the corrector's
    directions and steplengths of block 0 recorded, unpadded."""
    from ..ipm import step as step_mod

    real = step_mod.nt_scale, step_mod._schur, step_mod._group_dirs
    rec = {}

    def nt_scale(*a, **k):
        out = real[0](*a, **k)
        rec["W"] = out.W
        return out

    def schur(*a, **k):
        rec["H"] = real[1](*a, **k)
        return rec["H"]

    def group_dirs(*a, **k):
        out = real[2](*a, **k)
        if not k["predict"]:
            rec["dirs"] = out
        return out

    step_mod.nt_scale, step_mod._schur, step_mod._group_dirs = nt_scale, schur, group_dirs
    try:
        step_mod.step(problem, state, opts, *args, **kwargs)
    finally:
        step_mod.nt_scale, step_mod._schur, step_mod._group_dirs = real
    m = problem.groups[0].orig_sizes[0]
    d = rec["dirs"]

    def blk(x):
        return x[0, :m, :m].double().cpu().numpy()

    return {"X": blk(state.X[0]), "S": blk(state.S[0]), "W": blk(rec["W"]),
            "H": rec["H"].double().cpu().numpy(), "dX": blk(d.delX), "dS": blk(d.delS),
            "alpha": float(d.alpha[0]), "beta": float(d.beta[0])}


def solve_iterates(problem, options: dict, at, device: str = "cuda"):
    """(result, {k: `capture_step` at iteration k}): ``problem`` solved
    by `Solver`, then the steps of the iterations ``at`` (1-based; -1 is
    the last) redone from the iterates the solve stepped from, with the
    arguments it gave them."""
    from ..ipm import solver as solver_mod

    real = solver_mod.step
    calls = []

    def recording(p, st, o, *a, **k):
        calls.append((st, a, k))
        return real(p, st, o, *a, **k)

    solver = solver_mod.Solver(problem, options, device=device)
    solver_mod.step = recording
    try:
        res = solver.solve()
    finally:
        solver_mod.step = real
    out = {}
    for k in at:
        k = len(calls) if k == -1 else k
        st, a, kw = calls[k - 1]
        out[k] = capture_step(problem, st, solver.opts, *a, **kw)
    return res, out


def _sdpa_main(a) -> int:
    from ..problem import problem_from_sdpa

    at = [-1 if v == "last" else int(v) for v in a.at.split(",")]
    problem = problem_from_sdpa(a.sdpa, datarank=OPTS["datarank"], device=a.device)
    res, its = solve_iterates(problem, OPTS, at, a.device)
    print(json.dumps({"status": res.status, "iterations": res.iterations,
                      "objective": res.objective, "at": sorted(its)}), flush=True)
    arrays = {f"{name}_{k}": v for k, rec in its.items() for name, v in rec.items()}
    np.savez(a.out, sdpa=np.array(a.sdpa), iterations=np.array(sorted(its)), **arrays)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", type=int, nargs="?")
    ap.add_argument("cols", type=int, nargs="?")
    ap.add_argument("seed", type=int, nargs="?")
    ap.add_argument("--steps", type=int)
    ap.add_argument("--sdpa", help="an SDPA file to solve in place of a torus")
    ap.add_argument("--at", default="1,8,last", help="with --sdpa: the iterations to record")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.device == "cuda":
        from .cuda_build import build_libraries

        build_libraries("jacobi", "pcg")
    if a.sdpa:
        return _sdpa_main(a)
    if None in (a.rows, a.cols, a.seed, a.steps):
        ap.error("give ROWS COLS SEED --steps K, or --sdpa FILE")
    its = scale_iterates(a.rows, a.cols, a.seed, a.steps, a.device)
    for rec, _, _ in its:
        print(json.dumps(rec), flush=True)
    rec, X, S = its[-1]
    np.savez(a.out, graph=np.array([a.rows, a.cols, a.seed]), **{f"X_{rec['k']}": X,
                                                                 f"S_{rec['k']}": S})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
