"""The plain reference that decides ``correct``: NumPy only, from the
instance the benchmark made, nothing of the program.

A solve returns a primal-dual pair. In the program's internal form
(``max b^T y  s.t.  C - sum_j y_j A_j = S >= 0``, with b = -c, A_j = -F_j,
C = -F_0, and for a diagonal block C_lin[j, l] = -F_j[l, l], d_lin =
-F_0[l, l]) the pair is (X, X_lin) and (y, S). The reference rebuilds
b, C, the A_j and the LP data from the instance itself and computes the
six DIMACS errors of the returned pair (the convention of the program's
stopping test, `src/Solvers.jl:496-524` of Loraine.jl) in float64:

  err1 = ||b - A(X)|| / (1 + ||b||)
  err2 = sum_k max(0, -lmin(X_k)) / (1 + ||b||)      (+ the LP's min X_lin)
  err3 = sum_k ||C_k - S_k - A_k^T y||_F / (1 + ||C_k||_F)
  err4 = sum_k max(0, -lmin(S_k)) / (1 + ||C_k||_F)  (+ the LP's min S_lin)
  err5 = (<C, X> + d_lin^T X_lin - b^T y) / (1 + |<C, X>| + |b^T y|)
  err6 = sum_k <S_k, X_k> / (1 + |<C_k, X_k>| + |b^T y|) + S_lin^T X_lin / (...)

and ``dimacs = err1 + err2 + err3 + err4 + |err5| + err6``. A solve
returns no LP slack, so the reference takes S_lin = d_lin - C_lin^T y,
dual feasible by construction, and holds its sign in err4. It also
recomputes the SDPA objective c^T x (x = y) and compares it with the one
the program reported.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from instance import Instance


def _sym_from_upper(m: int, row, col, val) -> np.ndarray:
    M = np.zeros((m, m))
    np.add.at(M, (row, col), val)
    off = row != col
    np.add.at(M, (col[off], row[off]), val[off])
    return M


def dimacs_errors(inst: Instance, X: List[np.ndarray], S: List[np.ndarray],
                  y: np.ndarray, X_lin: Optional[np.ndarray]) -> Dict[str, float]:
    """The six DIMACS errors and their sum for the pair (X, X_lin), (y, S)
    of ``inst``; X and S list the LMI blocks in the instance's order. A pair
    with a non-finite entry reads inf in every error."""
    arrays = [*X, *S, y] + ([] if X_lin is None else [X_lin])
    if not all(np.isfinite(np.asarray(a, dtype=np.float64)).all() for a in arrays):
        inf = float("inf")
        return {k: inf for k in ("err1", "err2", "err3", "err4", "err5", "err6", "dimacs")}
    n = inst.nvar
    y = np.asarray(y, dtype=np.float64)
    b = -inst.c
    normb = float(np.linalg.norm(b))
    by = float(b @ y)
    AX = np.zeros(n)  # A(X) + C_lin X_lin
    err2 = err3 = err4 = 0.0
    trCX = 0.0
    SX_terms = []  # (<S_k, X_k>, <C_k, X_k>) per LMI block
    dX = SXl = 0.0
    lp_d, lp_cols = None, None
    k = 0
    xl0 = 0
    for size, (mat, row, col, val) in zip(inst.block_sizes, inst.blocks):
        f0 = mat == 0
        if size < 0:
            p = -size
            d = np.zeros(p)
            np.add.at(d, row[f0], -val[f0])
            xl = np.asarray(X_lin, dtype=np.float64)[xl0:xl0 + p]
            xl0 += p
            fj = ~f0
            # A(X) += C_lin xl, C_lin[j, l] = -F_j[l, l]
            np.add.at(AX, mat[fj] - 1, -val[fj] * xl[row[fj]])
            # S_lin = d_lin - C_lin^T y
            s = d.copy()
            np.add.at(s, row[fj], val[fj] * y[mat[fj] - 1])
            lp_d = d if lp_d is None else np.concatenate([lp_d, d])
            lp_cols = (xl, s) if lp_cols is None else (
                np.concatenate([lp_cols[0], xl]), np.concatenate([lp_cols[1], s]))
            continue
        m = size
        Xk = np.asarray(X[k], dtype=np.float64)
        Sk = np.asarray(S[k], dtype=np.float64)
        k += 1
        C = -_sym_from_upper(m, row[f0], col[f0], val[f0])
        fj = ~f0
        j, r, cc, v = mat[fj] - 1, row[fj], col[fj], -val[fj]  # A_j entries
        # <A_j, X> from the upper triangle: off-diagonal entries count twice
        w = np.where(r == cc, 1.0, 2.0)
        np.add.at(AX, j, w * v * Xk[r, cc])
        Aty = _sym_from_upper(m, r, cc, v * y[j])
        normC = float(np.linalg.norm(C))
        err3 += float(np.linalg.norm(C - Sk - Aty)) / (1.0 + normC)
        lx = float(np.linalg.eigvalsh(0.5 * (Xk + Xk.T))[0])
        ls = float(np.linalg.eigvalsh(0.5 * (Sk + Sk.T))[0])
        err2 += max(0.0, -lx) / (1.0 + normb)
        err4 += max(0.0, -ls) / (1.0 + normC)
        CX = float(np.sum(C * Xk))
        trCX += CX
        SX_terms.append((float(np.sum(Sk * Xk)), CX))
    err1 = float(np.linalg.norm(b - AX)) / (1.0 + normb)
    err6 = sum(sx / (1.0 + abs(cx) + abs(by)) for sx, cx in SX_terms)
    if lp_cols is not None:
        xl, s = lp_cols
        normd = float(np.linalg.norm(lp_d))
        dX = float(lp_d @ xl)
        SXl = float(s @ xl)
        err2 += max(0.0, -float(xl.min())) / (1.0 + normb)
        err4 += max(0.0, -float(s.min())) / (1.0 + normd)
        err6 += SXl / (1.0 + abs(dX) + abs(by))
    err5 = (trCX + dX - by) / (1.0 + abs(trCX) + abs(by))
    dimacs = err2 + err3 + err4 + abs(err5) + err6 + (err1 if SX_terms else 0.0)
    return {"err1": err1, "err2": err2, "err3": err3, "err4": err4, "err5": err5,
            "err6": err6, "dimacs": dimacs}


def objective(inst: Instance, y: np.ndarray) -> float:
    """The SDPA objective c^T x at x = y."""
    return float(inst.c @ np.asarray(y, dtype=np.float64))


def judge(inst: Instance, answer: dict) -> Dict[str, float]:
    """The numbers of one solve that ``correct`` compares: the reference's
    DIMACS sum of the returned pair; its infeasibility, the larger of the
    primal and the dual residual (err1, err3), which an IPM in float64
    drives to rounding level; and the relative gap between the reported
    objective and the reference's c^T x."""
    errs = dimacs_errors(inst, answer["X"], answer["S"], answer["y"], answer["X_lin"])
    ref = objective(inst, answer["y"])
    gap = abs(float(answer["objective"]) - ref) / (1.0 + abs(ref))
    if not math.isfinite(gap):
        gap = math.inf
    return {"dimacs": errs["dimacs"], "infeas": max(errs["err1"], errs["err3"]),
            "obj_gap": gap, "objective": ref}
