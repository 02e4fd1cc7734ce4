"""Theta SDPs built as SDPLIB's thetaG11 is, solved by the port on the CPU
and held against the benchmark's plain reference (`sdpbench/plain_step.py`),
closed-form optima and the JAX package.

SDPLIB's recipe for a graph on n nodes (`tests/data/thetaG11.dat-s`, n = 800):
one (n + 1) block, c = 1; F_0 = 0.5 on the first n diagonal entries and
0.25 in the last row; a constraint E_ii for each of the n + 1 diagonal
entries, and for each edge (i, j) the rank-1 (e_i + e_j + e_n)(...)^T. Its
optimum is the Lovasz theta number of the graph. The options are the
configuration's (kit 0, eDIMACS 1e-5, initpoint 1, datarank -1).
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

import loraine_tpu_torch as ltt
from loraine_tpu_torch.problem import problem_from_sdpa
from loraine_tpu_torch.utils import iterates

SDPBENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sdpbench")
if SDPBENCH not in sys.path:
    sys.path.insert(0, SDPBENCH)

import instance  # noqa: E402
import plain_step  # noqa: E402

OPTS = {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "datarank": -1, "verb": 0}

# Tolerances of the port's f64 step against the plain f64 reference, relative:
# - W and H (Frobenius): f64 rounding grows with the conditioning of the
#   iterate, to 1.1e-11 (W) and 1.7e-11 (H) at the 30-node graph's last
#   iterate; 1e-8 leaves 500x room and lies 25x below the float32 path's
#   errors at its first iterate (2.5e-7, 4.8e-7).
# - the steplengths: B2's bound on the smallest eigenvalue is a certified
#   float32 one, widened by 32 eps32 sqrt(m) of the matrix's scale, which
#   shortens the step by 3.4e-5 to 6.7e-5 of itself here; 1e-3 leaves 15x.
TOL = {"W": 1e-8, "H": 1e-8, "alpha": 1e-3, "beta": 1e-3}


def theta_sdpa(n, edges) -> str:
    """The SDPA text of SDPLIB's theta recipe (module docstring)."""
    nvar = n + 1 + len(edges)
    lines = [str(nvar), "1", str(n + 1), " ".join(["1.0"] * nvar)]
    for i in range(n):
        lines += [f"0 1 {i + 1} {i + 1} 0.5", f"0 1 {i + 1} {n + 1} 0.25"]
    lines += [f"{i + 1} 1 {i + 1} {i + 1} 1.0" for i in range(n + 1)]
    for k, (i, j) in enumerate(edges):
        i, j = min(i, j), max(i, j)
        lines += [f"{n + 2 + k} 1 {r + 1} {s + 1} 1.0"
                  for r, s in ((i, i), (i, j), (i, n), (j, j), (j, n), (n, n))]
    return "\n".join(lines) + "\n"


def cycle(n):
    return [(i, (i + 1) % n) for i in range(n)]


def torus(rows, cols):
    """The rows x cols toroidal grid, G11's shape (G11 is 20 x 40)."""
    edges = set()
    for a in range(rows):
        for b in range(cols):
            v = a * cols + b
            for w in (((a + 1) % rows) * cols + b, a * cols + (b + 1) % cols):
                edges.add((min(v, w), max(v, w)))
    return sorted(edges)


def random_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    return [(i, j) for i in range(n) for j in range(i + 1, n) if rng.random() < p]


@pytest.fixture(scope="module")
def graph30(tmp_path_factory):
    """A seeded random 30-node graph (86 edges: m = 117) as an SDPA file."""
    path = tmp_path_factory.mktemp("theta") / "r30.dat-s"
    path.write_text(theta_sdpa(30, random_graph(30, 0.2, 0)))
    return str(path)


def port_iterates(path, at, dtype=torch.float64):
    """The port's solve of ``path`` and its records at the iterations
    ``at``, as `loraine_tpu_torch.utils.iterates --sdpa` takes them, in
    the npz layout `plain_step.compare` reads."""
    opts = dict(OPTS, dtype="float32") if dtype == torch.float32 else OPTS
    p = problem_from_sdpa(path, datarank=-1, dtype=dtype, device="cpu")
    res, its = iterates.solve_iterates(p, opts, at, "cpu")
    f = {f"{name}_{k}": v for k, rec in its.items() for name, v in rec.items()}
    f["iterations"] = np.array(sorted(its))
    return res, f


@pytest.fixture(scope="module")
def compared(graph30):
    """The plain reference in float64 and float32 at iterations 1, 4 and
    the last of the port's f64 solve."""
    res, f = port_iterates(graph30, [1, 4, -1])
    inst = instance.read_sdpa(graph30)
    return res, {str(dt): plain_step.compare(f, inst, dt, "cpu")
                 for dt in (torch.float64, torch.float32)}


@pytest.mark.parametrize("at", [0, 1, 2], ids=["iteration1", "iteration4", "last"])
def test_step_matches_the_plain_reference(compared, at):
    res, recs = compared
    assert res.status == 1
    rec = recs["torch.float64"][at]
    assert rec["iteration"] == [1, 4, res.iterations][at]
    for name, tol in TOL.items():
        assert rec[name] <= tol, (name, rec)


def test_reference_in_float32_fails_a_tolerance(compared):
    """The reference computed one precision below the configuration's
    tells the port's f64 step apart at the last iterate."""
    _, recs = compared
    last = recs["torch.float32"][-1]
    assert any(last[name] > tol for name, tol in TOL.items()), last


def test_the_float32_path_fails_a_tolerance(graph30):
    """The port's own float32 path (dtype 'float32') against the f64
    reference: its first iterates already miss W's and H's tolerances."""
    _, f = port_iterates(graph30, [1, 4], torch.float32)
    for rec in plain_step.compare(f, instance.read_sdpa(graph30), torch.float64, "cpu"):
        assert rec["W"] > TOL["W"] and rec["H"] > TOL["H"], rec


THETA = {
    "C5": (5, cycle(5), math.sqrt(5.0)),
    "C7": (7, cycle(7), 7 * math.cos(math.pi / 7) / (1 + math.cos(math.pi / 7))),
    # bipartite, so theta = alpha = half the nodes: G11's 400 in small
    "torus4x6": (24, torus(4, 6), 12.0),
}


@pytest.mark.parametrize("name", sorted(THETA))
def test_closed_form_optimum(tmp_path, name):
    n, edges, theta = THETA[name]
    path = tmp_path / f"{name}.dat-s"
    path.write_text(theta_sdpa(n, edges))
    r = ltt.solve_sdpa(str(path), dict(OPTS, eDIMACS=1e-7), device="cpu")
    assert r.status == 1
    assert abs(r.objective - theta) <= 1e-7 * theta


def test_matches_jax_under_pallas_modes(graph30):
    import loraine_tpu as lt
    from torch_cases import PALLAS_MODES, errs_agree

    opts = dict(OPTS, **PALLAS_MODES)
    rj = lt.solve_sdpa(graph30, opts)
    rt = ltt.solve_sdpa(graph30, opts, device="cpu")
    assert rt.status == rj.status == 1
    assert rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= 1e-7 * abs(rj.objective)
    errs_agree(rj, rt, rtol=1e-4)
