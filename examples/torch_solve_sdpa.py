#!/usr/bin/env python
"""Solve an SDPA-format problem with loraine_tpu_torch, the PyTorch/CUDA
port (the counterpart of examples/solve_sdpa.py). Run from the repo root:

    python examples/torch_solve_sdpa.py [path/to/problem.dat-s] [--device cpu]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import loraine_tpu_torch as ltt

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("path", nargs="?", default=os.path.join(ROOT, "tests", "data", "theta1.dat-s"))
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

res = ltt.solve_sdpa(
    args.path,
    {
        "kit": 0,            # direct solver; 1 for preconditioned CG
        "eDIMACS": 1e-6,
        "preconditioner": 1,
        "erank": 1,
        "verb": 1,
        "datarank": 0,       # -1 for rank-one data (maxG11/thetaG11)
        "initpoint": 1,
        "maxit": 100,
    },
    device=args.device,
)
print(f"status     : {res.status_name}")
print(f"objective  : {res.objective}")
print(f"iterations : {res.iterations}")
assert res.status == 1
