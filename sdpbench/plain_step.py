#!/usr/bin/env python3
"""The plain reference of one interior-point iterate's work, in plain
PyTorch: the Nesterov-Todd scaling matrix W, the Schur matrix and the
largest steplengths. It imports nothing of the program and no JAX.

For an iterate (X, S) of one LMI block (X, S positive definite) of a
problem in the form max b^T y s.t. C - sum_i y_i A_i = S >= 0:

  W        the NT scaling, W S W = X: with X = Q diag(x) Q^T (``eigh``),
           R = X^{1/2}, M = R S R = P diag(m) P^T (``eigh``),
           W = R P diag(m^{-1/2}) P^T R;
  H        H_ij = tr(A_i W A_j W), from dense symmetric A_i (the definition,
           not a low-rank factor), contracted in blocks of constraints so
           that the dense A_i of m = 2401 constraints at n = 801 never exist
           at once: H[I, J] = vec(A_I) vec(W A_J W)^T;
  alpha    the largest alpha <= 1 with X + alpha dX >= 0, from the exact
           smallest eigenvalue lam of X^{-1/2} dX X^{-1/2} (``eigvalsh``):
           1 where lam >= -1, else -1/lam;
  rule     the steplength the interior-point method takes from lam
           (Loraine.jl, src/predictor_corrector.jl:274-291): 0.99 where
           lam > -1e-6, else min(1, -tau / lam) with tau = 0.95.

Departure: the guide for configurations asks for a float32 reference. The
configurations of this benchmark state float64 (eDIMACS 1e-5, and the
limits of ``correct`` near 1e-9), so the reference computes in float64 by
default, and float32 is what it must tell apart from a correct answer.
TF32 matrix products are switched off for the float32 runs.

From the root of a checkout: write request k of a cell's run with a seed
(the configuration's instance under the benchmark's relabeling), let the
program solve it and record its iterates, and hold them against this
reference, computed in float64 and in float32:

    python3 sdpbench/plain_step.py request --workload W --seed S --index K --out R.dat-s
    python3 -m loraine_tpu_torch.utils.iterates --sdpa R.dat-s --at 1,8,last --out R.npz
    python3 sdpbench/plain_step.py compare R.npz [--device cuda]

The last prints one JSON line per iterate and precision: the relative
error of the program's W and H (Frobenius) and of its two steplengths
(the corrector's, against the rule) beside the largest steplengths.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Callable, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

TAU = 0.95  # the fraction of the largest step taken (Loraine.jl's default)
STEP_EPS = -1e-6  # a direction this close to feasible takes 0.99


def _sym(A: torch.Tensor) -> torch.Tensor:
    return (A + A.mT) / 2


def nt_w(X: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """The NT scaling matrix W of (X, S): W S W = X."""
    x, Q = torch.linalg.eigh(_sym(X))
    R = (Q * x.clamp_min(0).sqrt()) @ Q.mT
    m, P = torch.linalg.eigh(_sym(R @ S @ R))
    Mis = (P * m.rsqrt()) @ P.mT
    return _sym(R @ Mis @ R)


def schur(W: torch.Tensor, constraints: Callable[[int, int], torch.Tensor], nvar: int,
          chunk: int = 128) -> torch.Tensor:
    """H_ij = tr(A_i W A_j W) for i, j < nvar; ``constraints(i0, i1)``
    returns the dense symmetric A_i, i0 <= i < i1, as [i1 - i0, n, n]."""
    H = W.new_zeros((nvar, nvar))
    for j0 in range(0, nvar, chunk):
        j1 = min(j0 + chunk, nvar)
        T = (W @ constraints(j0, j1) @ W).reshape(j1 - j0, -1)
        for i0 in range(0, nvar, chunk):
            i1 = min(i0 + chunk, nvar)
            H[i0:i1, j0:j1] = constraints(i0, i1).reshape(i1 - i0, -1) @ T.mT
    return H


def eigmin_scaled(X: torch.Tensor, dX: torch.Tensor) -> torch.Tensor:
    """The smallest eigenvalue of X^{-1/2} dX X^{-1/2} (X positive definite)."""
    x, Q = torch.linalg.eigh(_sym(X))
    Ri = (Q * x.rsqrt()) @ Q.mT
    return torch.linalg.eigvalsh(_sym(Ri @ dX @ Ri))[..., 0]


def steplength(X: torch.Tensor, dX: torch.Tensor) -> Tuple[float, float]:
    """(alpha, rule): the largest alpha <= 1 with X + alpha dX >= 0, and
    the step the method takes (module docstring)."""
    lam = float(eigmin_scaled(X, dX))
    alpha = 1.0 if lam >= -1.0 else -1.0 / lam
    rule = 0.99 if lam > STEP_EPS else min(1.0, -TAU / lam)
    return alpha, rule


def dense_constraints(inst, block: int, dtype, device) -> Callable[[int, int], torch.Tensor]:
    """The dense symmetric A_i = -F_i of LMI block ``block`` of an
    instance of `instance.py` (0-based i), as `schur` reads them."""
    mat, row, col, val = (torch.as_tensor(a, device=device) for a in inst.blocks[block])
    n = inst.block_sizes[block]
    keep = mat > 0
    mat, row, col, val = mat[keep] - 1, row[keep], col[keep], -val[keep]

    def constraints(i0: int, i1: int) -> torch.Tensor:
        sel = (mat >= i0) & (mat < i1)
        k, r, c, v = mat[sel] - i0, row[sel], col[sel], val[sel].to(dtype)
        A = torch.zeros((i1 - i0, n, n), dtype=dtype, device=device)
        A.index_put_((k, r, c), v, accumulate=True)
        off = r != c
        A.index_put_((k[off], c[off], r[off]), v[off], accumulate=True)
        return A

    return constraints


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| (Frobenius), in float64."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def compare(f, inst, dtype, device) -> list:
    """For each iterate of the program's file ``f`` (an npz mapping), the
    relative errors of the program's W, H and steplengths against this
    reference computed in ``dtype``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    A = dense_constraints(inst, 0, dtype, device)
    for k in [int(v) for v in f["iterations"]]:
        def get(name):
            return torch.as_tensor(f[f"{name}_{k}"]).to(device)

        X, S = get("X").to(dtype), get("S").to(dtype)
        W = nt_w(X, S)
        H = schur(W, A, inst.nvar)
        rec = {"iteration": k, "dtype": str(dtype).replace("torch.", ""),
               "W": _rel(get("W"), W), "H": _rel(get("H"), H)}
        for name, (M, dM) in {"alpha": (X, get("dX")), "beta": (S, get("dS"))}.items():
            best, rule = steplength(M, dM.to(dtype))
            port = float(f[f"{name}_{k}"])
            rec[name] = abs(port - rule) / rule
            rec[f"{name}_largest"] = best
        out.append(rec)
    return out


def write_sdpa(inst, path: str) -> None:
    """``inst`` as an SDPA sparse file, every value written exactly."""
    with open(path, "w") as f:
        f.write(f"{inst.nvar}\n{len(inst.block_sizes)}\n")
        f.write(" ".join(str(s) for s in inst.block_sizes) + "\n")
        f.write(" ".join(repr(float(v)) for v in inst.c) + "\n")
        for b, (mat, row, col, val) in enumerate(inst.blocks):
            for e in zip(mat.tolist(), row.tolist(), col.tolist(), val.tolist()):
                f.write(f"{e[0]} {b + 1} {e[1] + 1} {e[2] + 1} {e[3]!r}\n")


def main(argv=None) -> int:
    import argparse

    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    req = sub.add_parser("request", help="write request k of a cell's run with a seed")
    req.add_argument("--workload", required=True)
    req.add_argument("--seed", type=int, required=True)
    req.add_argument("--index", type=int, default=0)
    req.add_argument("--out", required=True)
    cmp_ = sub.add_parser("compare", help="hold a file of the program's iterates against this")
    cmp_.add_argument("npz")
    cmp_.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    args = ap.parse_args(argv)
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import instance as inst_mod

    if args.cmd == "request":
        import harness

        cell = harness.load_cell(args.workload)
        base = inst_mod.read_sdpa(os.path.join(ROOT, cell.config["instance"]))
        write_sdpa(inst_mod.relabel(base, inst_mod.request_rng(args.seed, args.index)), args.out)
        return 0
    f = dict(np.load(args.npz))
    inst = inst_mod.read_sdpa(str(f["sdpa"]))
    for dtype in (torch.float64, torch.float32):
        for rec in compare(f, inst, dtype, args.device):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
