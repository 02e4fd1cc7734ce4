"""The CG path (kit=1) of loraine_tpu_torch as a whole, against the JAX
package, on the CPU.

The JAX side runs with eigh_backend='pallas', step_eig='pallas' (the Pallas
Jacobi kernels in interpret mode) and cg_kernel='xla', the modes the port
resolves to on a CPU tensor ('auto' is the f64 CG of `ops/cg.py` there). The
two f32 Jacobi seeds differ at f32 rounding, which reaches the trajectory
through the steplength bounds (~1e-4 relative per step, as on the kit=0
path), and the CG solves stop at a loose tolerance, so CG counts are
compared per solve and in total rather than bit for bit.
"""
import pathlib

import numpy as np
import pytest
import torch

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from torch_cases import sized_problem

DATA = pathlib.Path(__file__).parent / "data"
CONTROL1 = str(DATA / "control1.dat-s")
THETA1 = str(DATA / "theta1.dat-s")
JAX_MODES = {"eigh_backend": "pallas", "step_eig": "pallas", "cg_kernel": "xla"}
# bench.py:77-79 and :93-95
CONTROL1_CG = {"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-6,
               "initpoint": 1, "verb": 0}
THETA1_CG = {"kit": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-5, "preconditioner": 1,
             "initpoint": 1, "verb": 0}


def _runs(path, opts):
    return (lt.solve_sdpa(path, dict(opts, **JAX_MODES)),
            ltt.solve_sdpa(path, opts, device="cpu"))


def test_control1_cg_matches_jax():
    # measured: 28 = 28 iterations, objective 7.1e-8 apart, 1556 vs 1557 CG
    # iterations. The last iterations are sensitive to rounding: a 1e-14
    # relative perturbation of b moves the port to 29 iterations and 1656 CG
    # iterations, hence one iteration of slack and, then, 10% on the total.
    rj, rt = _runs(CONTROL1, CONTROL1_CG)
    assert rt.status == rj.status == 1
    assert abs(rt.iterations - rj.iterations) <= 1
    assert abs(rt.objective - rj.objective) <= 1e-6 * abs(rj.objective)
    slack = 0.02 if rt.iterations == rj.iterations else 0.10
    assert abs(rt.cg_iterations - rj.cg_iterations) <= slack * rj.cg_iterations
    assert rt.cg_iterations == sum(h["cg_pre"] + h["cg_cor"] for h in rt.history)
    assert rt.dimacs < CONTROL1_CG["eDIMACS"]


def test_theta1_cg_matches_jax():
    # The two runs agree per iteration while DIMACS > 1e-4 (measured: CG
    # counts within 1 per solve, DIMACS within 0.2%). The endgame at
    # tol_cg_min = 1e-5 is chaotic: from JAX's own iterate 11, a 1e-15
    # relative perturbation of y moves the next step's DIMACS from 6.3e-6 to
    # 2.1e-6 or 7.4e-6 and its CG counts by up to 4 (measured), so the
    # iteration count at which DIMACS first falls below 1e-5 is not held
    # (measured: JAX 12, port 15).
    rj, rt = _runs(THETA1, THETA1_CG)
    assert rt.status == rj.status == 1
    assert abs(rt.objective - rj.objective) <= 1e-6 * abs(rj.objective)
    assert abs(rt.objective - 23.0) <= 1e-5 * 23.0
    k = sum(1 for h in rj.history if h["dimacs"] > 1e-4)
    assert k >= 8
    for hj, ht in zip(rj.history[:k], rt.history[:k]):
        assert abs(ht["dimacs"] - hj["dimacs"]) <= 1e-2 * hj["dimacs"]
        assert abs(ht["cg_pre"] - hj["cg_pre"]) <= 2 and abs(ht["cg_cor"] - hj["cg_cor"]) <= 2


def test_theta1_matrix_free_matches_jax():
    # cg_materialize='never': pcg with the operator Aop(W Aadj(x) W) and the
    # SMW H_alpha (measured: objective 8.8e-8 apart)
    rj, rt = _runs(THETA1, dict(THETA1_CG, cg_materialize="never"))
    assert rt.status == rj.status == 1
    assert abs(rt.objective - rj.objective) <= 1e-6 * abs(rj.objective)
    assert rt.cg_iterations > 0


@pytest.mark.parametrize("cg_kernel,opts,obj_rtol", [
    # the plain version of B3 (f64 min-residual CG + f64 polish)
    ("ff", CONTROL1_CG, 1e-5),
    # the plain version of B4 at the loose options of
    # tests/test_pcg_pallas.py:76-82 (the f32 body stalls near convergence)
    ("pallas", {"kit": 1, "preconditioner": 1, "eDIMACS": 3e-3, "tol_cg_min": 1e-4,
                "initpoint": 1, "verb": 0, "maxit": 40}, 1e-3),
])
def test_control1_with_kernel_bodies(cg_kernel, opts, obj_rtol):
    r = ltt.solve_sdpa(CONTROL1, dict(opts, cg_kernel=cg_kernel), device="cpu")
    assert r.status == 1
    assert abs(r.objective - 17.78463) <= obj_rtol * 17.78463
    assert r.cg_iterations > 0


def test_cg_kernel_auto_resolution():
    # the card's default is B3 up to n = 1024 (step.py:790-801); the CPU
    # runs the f64 'xla' loop, as the JAX package on its CPU backend
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def resolve_cg_kernel(cg_kernel, n, device):
        return ltt.Options(cg_kernel=cg_kernel).resolved(sized_problem(n), device).cg_kernel

    assert resolve_cg_kernel("auto", 464, cuda) == "ff"
    assert resolve_cg_kernel("auto", 1024, cuda) == "ff"
    assert resolve_cg_kernel("auto", 1025, cuda) == "xla"
    assert resolve_cg_kernel("auto", 21, cpu) == "xla"
    assert resolve_cg_kernel("pallas", 5000, cpu) == "pallas"


def test_kit1_downgrades_and_logs(capsys):
    # erank >= max block size - 1 falls back to the direct solver, as in the
    # JAX package (tests/test_iterative.py:106-113)
    p = ltt.load_problem(CONTROL1, device="cpu")
    with pytest.warns(UserWarning, match="direct solver"):
        r = ltt.solve(p, dict(CONTROL1_CG, erank=20, maxit=2), device="cpu")
    assert r.cg_iterations == 0
    r = ltt.solve(p, dict(CONTROL1_CG, verb=2, maxit=2), device="cpu")
    out = capsys.readouterr().out
    assert "Preconditioner     :     1" in out and "cg_pre  cg_cor" in out
    assert f"Total CG iterations: {r.cg_iterations:8d}" in out
    assert [h["cg_pre"] > 0 and h["cg_cor"] > 0 for h in r.history] == [True, True]
    assert np.isfinite(r.dimacs)
