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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", type=int)
    ap.add_argument("cols", type=int)
    ap.add_argument("seed", type=int)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.device == "cuda":
        from .cuda_build import build_libraries

        build_libraries("jacobi", "pcg")
    its = scale_iterates(a.rows, a.cols, a.seed, a.steps, a.device)
    for rec, _, _ in its:
        print(json.dumps(rec), flush=True)
    rec, X, S = its[-1]
    np.savez(a.out, graph=np.array([a.rows, a.cols, a.seed]), **{f"X_{rec['k']}": X,
                                                                 f"S_{rec['k']}": S})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
