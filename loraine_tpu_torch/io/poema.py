"""POEMA-JSON and MATLAB .mat problem readers. Port of
`loraine_tpu/io/poema.py`, pure numpy, kept as the port's own copy.

The reference ships (unshipped, in `TBD/`) a POEMA-JSON reader
(`TBD/solve_json.jl:17-81`) and a MAT-file reader (`TBD/tvp.jl:15-20`),
both driving the broken raw-dict entry `loraine(d, options)`
(`src/Loraine.jl:30-93`). Here both formats load into the same raw-dict
convention consumed by :func:`loraine_tpu_torch.problem.problem_from_dict`
(which replicates `prepare_model_data`'s sign handling,
`src/model.jl:90-118`: internal A_j = -A[i][j], C_i = -C[i], b = -c).

POEMA-JSON schema (as consumed by the reference reader):

    {"name": ..., "type": ..., "nvar": n, "objective": [c_1..c_n],
     "constraints": {
        "nlmi": k, "msizes": [m_1..m_k],
        "lmi_symat": [[val, ivar, iblk, row, col], ...],   # 1-based rows/
            # cols and blocks; ivar 0 = constant matrix, 1..n = A_ivar;
            # one triangle stored (symmetrized on load)
        "nlsi": p, "lsi_mat": [[val, row, col], ...],      # p x n
        "lsi_vec": [d_1..d_p], "lsi_op": [...]             # op flags
     }}

The stored matrices coincide with SDPA's F matrices (constant = F_0,
A_j = F_j), so `min c'x s.t. sum_j x_j F_j - F_0 >= 0` round-trips through
this format bit-exactly.
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

__all__ = ["read_poema_json", "write_poema_json", "read_mat_dict"]


def _sym_from_coo(m: int, rows, cols, vals) -> np.ndarray:
    M = np.zeros((m, m))
    r = np.asarray(rows, dtype=np.int64)
    c = np.asarray(cols, dtype=np.int64)
    v = np.asarray(vals, dtype=np.float64)
    np.add.at(M, (r, c), v)
    # mirror the stored triangle (diagonal untouched)
    off = r != c
    np.add.at(M, (c[off], r[off]), v[off])
    return M


def read_poema_json(path: str) -> dict:
    """Parse a POEMA-JSON file into the raw problem dict
    (`problem_from_dict` convention). The reference's reader is
    `TBD/solve_json.jl:17-81`."""
    with open(path) as f:
        raw = json.load(f)
    n = int(raw["nvar"])
    con = raw["constraints"]
    nlmi = int(con["nlmi"])
    msizes = np.atleast_1d(np.asarray(con["msizes"], dtype=np.int64))

    entries = con.get("lmi_symat", [])
    per_block: List[List[list]] = [[] for _ in range(nlmi)]
    for val, ivar, iblk, row, col in entries:
        per_block[int(iblk) - 1].append((float(val), int(ivar), int(row) - 1, int(col) - 1))
    A: List[np.ndarray] = []
    C: List[np.ndarray] = []
    for i in range(nlmi):
        m = int(msizes[i])
        ent = per_block[i]
        stack = np.zeros((n, m, m))
        c_rows = [(r, c, v) for v, j, r, c in ent if j == 0]
        if c_rows:
            rr, cc, vv = zip(*c_rows)
            Cmat = _sym_from_coo(m, rr, cc, vv)
        else:
            Cmat = np.zeros((m, m))
        for j in range(1, n + 1):
            j_rows = [(r, c, v) for v, jj, r, c in ent if jj == j]
            if j_rows:
                rr, cc, vv = zip(*j_rows)
                stack[j - 1] = _sym_from_coo(m, rr, cc, vv)
        A.append(stack)
        C.append(Cmat)

    d: dict = {
        "name": raw.get("name"),
        "nvar": n,
        "nlmi": nlmi,
        "msizes": msizes,
        "c": np.asarray(raw["objective"], dtype=np.float64),
        "A": A,
        "C": C,
        "b_const": float(raw.get("b_const", 0.0)),
    }
    nlsi = int(con.get("nlsi", 0))
    if nlsi > 0:
        Clin = np.zeros((n, nlsi))
        for val, row, col in con["lsi_mat"]:
            # file stores the p x n system row-major; we keep C_lin as n x p
            Clin[int(col) - 1, int(row) - 1] += float(val)
        d["nlin"] = nlsi
        d["C_lin"] = Clin
        d["d"] = np.asarray(con["lsi_vec"], dtype=np.float64).reshape(-1)
    else:
        d["nlin"] = 0
    return d


def write_poema_json(path: str, d: dict) -> None:
    """Write a raw problem dict (reader convention above) as POEMA-JSON."""
    n = int(d["nvar"])
    nlmi = int(d["nlmi"])
    msizes = [int(x) for x in np.atleast_1d(d["msizes"])]
    lmi = []
    for i in range(nlmi):
        Cmat = np.asarray(d["C"][i])
        for r, c in zip(*np.nonzero(np.triu(Cmat))):
            lmi.append([float(Cmat[r, c]), 0, i + 1, int(r) + 1, int(c) + 1])
        Ai = np.asarray(d["A"][i])
        for j in range(n):
            for r, c in zip(*np.nonzero(np.triu(Ai[j]))):
                lmi.append([float(Ai[j][r, c]), j + 1, i + 1, int(r) + 1, int(c) + 1])
    con: dict = {"nlmi": nlmi, "msizes": msizes if nlmi > 1 else msizes[0],
                 "lmi_symat": lmi}
    nlin = int(d.get("nlin", 0))
    con["nlsi"] = nlin
    if nlin:
        Clin = np.asarray(d["C_lin"])  # [n, p]
        lsi = []
        for col, row in zip(*np.nonzero(Clin)):
            lsi.append([float(Clin[col, row]), int(row) + 1, int(col) + 1])
        con["lsi_mat"] = lsi
        con["lsi_vec"] = [float(x) for x in np.asarray(d["d"]).reshape(-1)]
        con["lsi_op"] = [1] * nlin
    out = {
        "name": d.get("name", "problem"),
        "type": "sdp",
        "nvar": n,
        "objective": [float(x) for x in np.asarray(d["c"]).reshape(-1)],
        "constraints": con,
    }
    with open(path, "w") as f:
        json.dump(out, f)


def read_mat_dict(path: str, var: str = "d") -> dict:
    """Read a MATLAB .mat file holding the raw problem dict (struct ``d``),
    the reference's `TBD/tvp.jl:15-20` flow. Requires scipy."""
    from scipy.io import loadmat

    raw = loadmat(path, simplify_cells=True)
    if var not in raw:
        raise ValueError(f"variable {var!r} not in {path}; has {sorted(k for k in raw if not k.startswith('__'))}")
    d = dict(raw[var])
    d.setdefault("b_const", 0.0)
    nlmi = int(np.asarray(d.get("nlmi", 1)).reshape(-1)[0])
    # MATLAB cell arrays of per-block matrices arrive as object arrays (or
    # squeezed plain arrays for a single block); normalize A to
    # list-of-[n,m,m] and C to list-of-[m,m]
    if "A" in d:
        A = d["A"]
        if isinstance(A, np.ndarray) and A.dtype == object:
            d["A"] = [
                np.stack([np.asarray(Aij, dtype=np.float64) for Aij in Ai])
                for Ai in A
            ]
        elif isinstance(A, np.ndarray) and A.ndim == 3 and nlmi == 1:
            d["A"] = [np.asarray(A, dtype=np.float64)]
    if "C" in d:
        C = d["C"]
        if isinstance(C, np.ndarray) and C.dtype == object:
            d["C"] = [np.asarray(Ci, dtype=np.float64) for Ci in C]
        elif isinstance(C, np.ndarray) and C.ndim == 2 and nlmi == 1:
            d["C"] = [np.asarray(C, dtype=np.float64)]
    return d
