"""The step and solve modes of loraine_tpu_torch against the JAX package, on
the CPU: every ``step_eig``, ``eigh_backend``, ``nt_method``, ``dtype`` and
``assembly_precision`` value beside the kernel modes of test_torch_solve.py.

(a) One step of each package from the same JAX iterate (theta1 after 4
iterations under EXACT_MODES), both under the same modes (`step_both`, no
patch): every stat and the new iterate within 1e-10 relative (1e-13
absolute for errors at their floor). With the f32 Schur assembly the two
packages' f32 GEMMs (two BLAS builds) round differently, H agrees to
~1e-7 relative and the step to ~4e-8 (measured): there 1e-6.

(b) Whole solves: theta1 under the JAX CPU run's own 'auto' resolution
(eigh_backend 'jacobi' at m = 50 < 192, step_eig 'exact') in both packages,
same iterations and objectives within 1e-9; the port's mirrors of
tests/test_conformance.py's configs 6-7, `test_step_eig_chol_e2e`,
`test_e2e_lanczos_steplengths`, `test_float32_mode` and
`test_mixed_assembly_e2e_and_validation` (with the handover to the f64
assembly at the same iteration as the JAX package's). The port runs its
fast exact modes ('xla') where the JAX test leaves the eigen modes at
'auto'.

(c) Under -m slow: maxG11 at full size (bench.py:84-85) through both
packages under eigh_backend='mixed', step_eig='exact', what the JAX CPU
'auto' resolves to at m = 800 (ROADMAP Queue C 1).
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from loraine_tpu.problem import problem_from_sdpa as jax_problem_from_sdpa
from test_conformance import _check_kkt, _random_feasible_sdp
from torch_cases import EXACT_MODES, assert_same_step, step_both

DATA = pathlib.Path(__file__).parent / "data"
THETA1 = str(DATA / "theta1.dat-s")
MAXG11 = str(DATA / "maxG11.dat-s")
K0 = {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0}
# bench.py:77-79 (control1-cg)
K1 = {"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-6,
      "initpoint": 1, "verb": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager Jacobi and Lanczos loops here are 10^4-10^5 tiny torch ops
    each. With several test workers on one machine, torch's intra-op thread
    pool turns every op into a contended barrier (a 3-iteration theta1
    solve under 'jacobi': 1.5 s on one thread, 185 s on eight beside five
    busy processes). One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def theta1_mid():
    pj = jax_problem_from_sdpa(THETA1)
    return pj, lt.solve(pj, dict(K0, **EXACT_MODES, maxit=4)).final_state


STEP_CASES = {
    "exact-xla": (K0, {}),
    "exact-jacobi": (K0, {"eigh_backend": "jacobi"}),
    "exact-mixed": (K0, {"eigh_backend": "mixed"}),
    "chol-xla": (K0, {"step_eig": "chol"}),
    "lanczos-xla": (K0, {"step_eig": "lanczos"}),
    "svd-xla": (K0, {"nt_method": "svd"}),
    "f32-assembly": (dict(K0, assembly_precision="f32"), {}),
    # the preconditioner's eigendecompositions of W under 'jacobi'/'mixed'
    "kit1-exact-jacobi": (K1, {"eigh_backend": "jacobi"}),
    "kit1-exact-mixed": (K1, {"eigh_backend": "mixed"}),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_step_modes_match_jax(theta1_mid, case):
    pj, mid = theta1_mid
    opts, modes = STEP_CASES[case]
    mixed = opts.get("assembly_precision") == "f32"
    j, t = step_both(pj, mid, opts, modes=dict(EXACT_MODES, **modes), mixed_assembly=mixed)
    assert_same_step(j, t, rtol=1e-6 if mixed else 1e-10)


def test_theta1_jax_cpu_auto_modes_match():
    """The JAX package's CPU 'auto' at theta1 is eigh_backend 'jacobi'
    (m = 50 < AUTO_XLA_MIN_M) with exact steplengths from 7 Jacobi sweeps:
    the same 11 iterations in both packages, objectives within 1e-9 and the
    per-iteration DIMACS within 1e-6 relative."""
    modes = {"eigh_backend": "jacobi", "step_eig": "exact"}
    rj = lt.solve_sdpa(THETA1, K0)  # 'auto' on the JAX CPU backend
    rt = ltt.solve_sdpa(THETA1, dict(K0, **modes), device="cpu")
    assert rj.status == rt.status == 1
    assert rt.iterations == rj.iterations == 11
    assert abs(rt.objective - rj.objective) <= 1e-9
    dj = np.array([h["dimacs"] for h in rj.history])
    dt = np.array([h["dimacs"] for h in rt.history])
    assert np.max(np.abs(dt - dj) / dj) < 1e-6


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cfg", [
    {"kit": 0, "initpoint": 1, "nt_method": "svd", "eigh_backend": "xla"},
    {"kit": 0, "initpoint": 1, "step_eig": "chol", "eigh_backend": "xla"},
], ids=["6", "7"])
def test_kkt_conformance_modes(cfg, seed):
    """tests/test_conformance.py configs 6-7 (config 7 with the port's exact
    NT eigensolver 'xla' for speed) on the port: OPTIMAL and the KKT
    conditions at 1e-6."""
    data = _random_feasible_sdp(seed)
    As, Cs, b, C_lin, d_lin = data
    prob = ltt.problem_from_dense(As, Cs, b, C_lin=C_lin, d_lin=d_lin, device="cpu")
    res = ltt.solve(prob, {**cfg, "eDIMACS": 1e-7, "verb": 0}, device="cpu")
    assert res.status == 1, res.status_name
    _check_kkt(data, res, 1e-6)


def test_step_eig_chol_e2e():
    """tests/test_nt_scaling.py:63-76: the Cholesky-bisection steplengths
    reach the exact ones' objective within 1e-6 relative, iterations within
    one."""
    ref = ltt.solve_sdpa(THETA1, dict(K0, **EXACT_MODES), device="cpu")
    res = ltt.solve_sdpa(THETA1, dict(K0, **dict(EXACT_MODES, step_eig="chol")), device="cpu")
    assert res.status == 1
    np.testing.assert_allclose(res.objective, ref.objective, rtol=1e-6)
    assert abs(res.iterations - ref.iterations) <= 1


def test_e2e_lanczos_steplengths():
    """tests/test_eigmin_lanczos.py:47-54."""
    r = ltt.solve_sdpa(THETA1, dict(K0, **dict(EXACT_MODES, step_eig="lanczos")), device="cpu")
    assert r.status == 1
    assert abs(r.objective - 23.0) < 1e-4


def test_lanczos_control1_stops_as_in_jax():
    """control1 (kit=0) under step_eig='lanczos' reaches no solution in
    either package: the 48-step Lanczos bound carries no certificate and
    oversteps on control1's padded blocks, so both stop at the iteration
    limit, DIMACS far above eDIMACS (the JAX package: 2.27 at iteration
    100)."""
    opts = dict(K0, eDIMACS=1e-5, maxit=25, **dict(EXACT_MODES, step_eig="lanczos"))
    path = str(DATA / "control1.dat-s")
    rj = lt.solve_sdpa(path, opts)
    rt = ltt.solve_sdpa(path, opts, device="cpu")
    assert rj.status == rt.status == 4 and rj.iterations == rt.iterations == 25
    assert rj.dimacs > 1.0 and rt.dimacs > 1.0


F32 = {"kit": 0, "eDIMACS": 5e-3, "initpoint": 1, "verb": 0, "dtype": "float32", "maxit": 50}


def test_float32_mode():
    """tests/test_robustness.py:8-15 on the port's own modes (the B1/B2
    plain versions on f32 data): the objective to 5e-2 of 23."""
    res = ltt.solve_sdpa(THETA1, F32, device="cpu")
    assert res.status in (1, 4)
    np.testing.assert_allclose(res.objective, 23.0, rtol=5e-2)
    assert res.final_state.X[0].dtype == res.final_state.y.dtype == torch.float32


@pytest.mark.parametrize("cg_kernel", ["ff", "pallas"])
def test_float32_cg_kernel_route(cg_kernel):
    """f32 data on the kit=1 kernel route (on a card: B3 or B4 and the
    polish; here their plain versions), which runs on f64 copies of the f32
    operator and hands back an f32 solution: theta1 OPTIMAL near 23."""
    opts = dict(K1, eDIMACS=5e-3, tol_cg_min=1e-4, dtype="float32", maxit=50,
                cg_kernel=cg_kernel)
    r = ltt.solve_sdpa(THETA1, opts, device="cpu")
    assert r.status == 1 and abs(r.objective - 23.0) <= 1e-3 * 23.0
    assert r.cg_iterations > 0 and r.final_state.y.dtype == torch.float32


@pytest.mark.parametrize("name", ["theta1", "control1"])
def test_float32_kit1_matches_jax(name):
    """f32 on the CG path (control1-cg's options at eDIMACS 5e-3, maxit 50),
    as far as the JAX package runs it on the CPU (EXACT_MODES; the f32
    `cg_plain`). theta1: both OPTIMAL in the same iterations, objectives to
    1e-5 of each other and 1e-3 of 23. control1: the JAX package's f32 run
    breaks down (DIMACS NaN after ~27 iterations, status 3), and so does
    the port's: the library eigensolver's failure on the broken iterate
    comes back as NaN, as `jnp.linalg` returns it, and not as an exception."""
    opts = dict(K1, eDIMACS=5e-3, tol_cg_min=1e-4, dtype="float32", maxit=50, **EXACT_MODES)
    path = str(DATA / f"{name}.dat-s")
    rj = lt.solve_sdpa(path, opts)
    rt = ltt.solve_sdpa(path, opts, device="cpu")
    if name == "theta1":
        assert rj.status == rt.status == 1
        assert rt.iterations == rj.iterations
        assert abs(rt.objective - rj.objective) <= 1e-5 * 23.0
        assert abs(rt.objective - 23.0) <= 1e-3 * 23.0
    else:
        assert rj.status == rt.status == 3
        assert not np.isfinite(rj.dimacs) and not np.isfinite(rt.dimacs)
        assert abs(rt.iterations - rj.iterations) <= 5


def _jax_handover(capsys, path, opts) -> int:
    """The JAX package's handover iteration: the last iteration row printed
    (verb=1) before "Switching to exact f64 Schur assembly"."""
    capsys.readouterr()
    lt.solve_sdpa(path, dict(opts, verb=1))
    out = capsys.readouterr().out.splitlines()
    k = next(i for i, line in enumerate(out) if "Switching to exact f64 Schur assembly" in line)
    rows = [int(m_.group(1)) for m_ in (re.match(r"^\s*(\d+)\s+\S+\s+\S+\s+\S+$", line)
                                        for line in out[:k]) if m_]
    return rows[-1]


def test_mixed_assembly_e2e_and_validation(capsys):
    """tests/test_schur.py:195-211 on the port, and the handover: the f32
    assembly hands over to f64 after the first iteration with DIMACS below
    1e-3, at the same iteration as in the JAX package."""
    opts = dict(K0, **EXACT_MODES)
    r64 = ltt.solve_sdpa(THETA1, opts, device="cpu")
    r32 = ltt.solve_sdpa(THETA1, dict(opts, assembly_precision="f32"), device="cpu")
    assert r32.status == 1
    assert abs(r32.objective - r64.objective) < 1e-6
    assert abs(r32.iterations - r64.iterations) <= 2
    k = r32.mixed_handover
    dimacs = [h["dimacs"] for h in r32.history]
    assert k is not None and dimacs[k - 1] < 1e-3 <= min(dimacs[: k - 1])
    assert k == _jax_handover(capsys, THETA1, dict(opts, assembly_precision="f32"))
    # 'auto' engages only on a CUDA device: no f32 assembly on the CPU
    assert ltt.solve_sdpa(THETA1, dict(opts, assembly_precision="auto"),
                          device="cpu").mixed_handover is None
    with pytest.raises(ValueError):
        ltt.Options(assembly_precision="f32", precision="dd").validated()
    with pytest.raises(ValueError):
        ltt.Options(assembly_precision="bogus").validated()


@pytest.mark.slow
def test_maxg11_under_jax_cpu_modes():
    """ROADMAP Queue C 1: maxG11 at full size (bench.py:84-85) in both
    packages under the modes the JAX CPU 'auto' resolves to at m = 800
    (eigh_backend 'mixed', step_eig 'exact'); the JAX package's CPU run took
    14 iterations to 629.16479325 (benchmarks/results_cpu_r2.jsonl:5).
    Same iterations; objectives within 1e-6 relative; per-iteration DIMACS
    within 1e-3 relative (the f32 seeds of two LAPACK builds differ, the
    refinement takes both to f64)."""
    opts = {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "datarank": -1, "verb": 0,
            "eigh_backend": "mixed", "step_eig": "exact"}
    rj = lt.solve_sdpa(MAXG11, opts)
    rt = ltt.solve_sdpa(MAXG11, opts, device="cpu")
    assert rj.status == rt.status == 1
    assert rt.iterations == rj.iterations == 14
    assert abs(rt.objective - rj.objective) <= 1e-6 * abs(rj.objective)
    assert abs(rt.objective - 629.16479325) <= 1e-6 * 629.16479325
    dj = np.array([h["dimacs"] for h in rj.history])
    dt = np.array([h["dimacs"] for h in rt.history])
    assert np.max(np.abs(dt - dj) / dj) < 1e-3
