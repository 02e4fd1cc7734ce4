"""The loraine_tpu_torch slice as a whole, against the JAX package.

The JAX side runs with eigh_backend='pallas' and step_eig='pallas' (the
Pallas Jacobi kernels in interpret mode), the modes the port's 'auto'
resolves to; the port runs on the CPU with the kernels' plain versions.
The two f32 Jacobi seeds differ at f32 rounding; the f64 refinement absorbs
it in the directions, while the steplength bounds carry it into the
trajectory at ~1e-4 relative. Hence: equal status and iteration count,
objective within 1e-7 relative, per-iteration DIMACS within 1e-2 relative.
"""
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from loraine_tpu.io.sdpa import SDPAData as JaxSDPAData
from loraine_tpu.problem import problem_from_sdpa as jax_problem_from_sdpa
from loraine_tpu_torch.convert import problem_from_numpy, state_from_numpy
from loraine_tpu_torch.ipm.step import step as torch_step
from torch_cases import maxcut_sdpa

DATA = pathlib.Path(__file__).parent / "data"
PORT_OPTS = {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0}
JAX_OPTS = dict(PORT_OPTS, eigh_backend="pallas", step_eig="pallas")
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def theta1_runs():
    rj = lt.solve_sdpa(str(DATA / "theta1.dat-s"), JAX_OPTS)
    rt = ltt.solve_sdpa(str(DATA / "theta1.dat-s"), PORT_OPTS, device="cpu")
    return rj, rt


@pytest.fixture(scope="module")
def maxcut_problems():
    pj = jax_problem_from_sdpa(maxcut_sdpa(cls=JaxSDPAData), datarank=-1)
    pt = ltt.problem_from_sdpa(maxcut_sdpa(), datarank=-1, device="cpu")
    return pj, pt


@pytest.fixture(scope="module")
def maxcut_runs(maxcut_problems):
    pj, pt = maxcut_problems
    return lt.solve(pj, JAX_OPTS), ltt.solve(pt, PORT_OPTS, device="cpu")


def _assert_same_solve(rj, rt):
    assert rt.status == rj.status == 1
    assert rt.status_name == "OPTIMAL"
    assert rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= 1e-7 * abs(rj.objective)
    dj = np.array([h["dimacs"] for h in rj.history])
    dt = np.array([h["dimacs"] for h in rt.history])
    assert np.max(np.abs(dt - dj) / dj) < 1e-2
    assert len(rt.iteration_times) == rt.iterations


def test_theta1_matches_jax(theta1_runs):
    rj, rt = theta1_runs
    assert rj.iterations == 11
    _assert_same_solve(rj, rt)
    assert abs(rt.objective - 23.0) < 1e-5
    assert rt.X[0].shape == (50, 50) and np.isfinite(rt.X[0]).all()


def test_control1_multiblock_matches_jax():
    """control1: two blocks (10 and 5) packed into one group of 2 x 16.
    Measured 28 = 28 iterations, objective 2.1e-7 apart (the f32 seeds reach
    the trajectory through the steplength bounds, as above)."""
    opts = dict(PORT_OPTS, eDIMACS=1e-5)
    rj = lt.solve_sdpa(str(DATA / "control1.dat-s"), dict(opts, eigh_backend="pallas",
                                                           step_eig="pallas"))
    rt = ltt.solve_sdpa(str(DATA / "control1.dat-s"), opts, device="cpu")
    assert rt.status == rj.status == 1
    assert rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= 1e-6 * abs(rj.objective)
    assert [X.shape for X in rt.X] == [(10, 10), (5, 5)]
    assert rt.cg_iterations == 0


def test_maxcut_rank1_matches_jax(maxcut_runs):
    rj, rt = maxcut_runs
    assert rj.iterations == 11
    _assert_same_solve(rj, rt)


def test_one_step_from_jax_state_matches(maxcut_problems):
    """Both packages take one step from the same mid-solve iterate (JAX's,
    after 4 iterations, carried across by convert.state_from_numpy)."""
    from loraine_tpu.ipm.step import build_step

    pj, _ = maxcut_problems
    mid = lt.solve(pj, dict(JAX_OPTS, maxit=4)).final_state
    opts_j = lt.Options.from_dict(JAX_OPTS).validated()
    new_j, stats_j = jax.jit(build_step(opts_j, -1))(pj, mid, 1e-2)
    pt = problem_from_numpy(jax.device_get(pj), device="cpu")
    st = state_from_numpy(jax.device_get(mid), device="cpu")
    new_t, stats_t = torch_step(pt, st, ltt.Options.from_dict(PORT_OPTS).validated())

    # mu is f64 arithmetic on the shared iterate; the steplengths come from
    # the certified bounds, whose f32 seeds differ at f32 rounding (measured
    # <= 1e-5 relative along this solve), and sigma from the predictor steps
    assert abs(float(stats_t.mu) - float(stats_j.mu)) <= 1e-12 * float(stats_j.mu)
    for k in ("alpha_min", "beta_min", "sigma"):
        a, b = float(getattr(stats_t, k)), float(getattr(stats_j, k))
        assert abs(a - b) <= 5e-5 * abs(b), k
    # directions (delX, delS, dely = (new - old) / step): f64 solves on the
    # f64-refined NT scaling; the corrector inherits sigma's difference
    # through sigma*mu (measured <= 1.2e-7 relative)
    amin_t, bmin_t = float(stats_t.alpha_min), float(stats_t.beta_min)
    amin_j, bmin_j = float(stats_j.alpha_min), float(stats_j.beta_min)
    X0, S0, y0 = np.asarray(mid.X[0]), np.asarray(mid.S[0]), np.asarray(mid.y)
    pairs = [
        ((new_t.X[0].numpy() - X0) / amin_t, (np.asarray(new_j.X[0]) - X0) / amin_j),
        ((new_t.S[0].numpy() - S0) / bmin_t, (np.asarray(new_j.S[0]) - S0) / bmin_j),
        ((new_t.y.numpy() - y0) / bmin_t, (np.asarray(new_j.y) - y0) / bmin_j),
    ]
    for dt, dj in pairs:
        assert np.abs(dt - dj).max() <= 1e-6 * np.abs(dj).max()
    assert bool(stats_t.nt_ok) and stats_t.h_ok and stats_t.h_shifts == int(stats_j.h_shifts)


def test_iteration_limit_status(maxcut_problems):
    _, pt = maxcut_problems
    r = ltt.solve(pt, dict(PORT_OPTS, maxit=2), device="cpu")
    assert (r.status, r.status_name, r.iterations) == (4, "ITERATION_LIMIT", 2)
    assert len(r.history) == 2 and np.isfinite(r.dimacs)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import loraine_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'loraine_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'loraine_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
    for path in (REPO / "loraine_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] in ("jax", "jaxlib", "loraine_tpu")), (path, line)


@pytest.mark.parametrize("opts,exc,match", [
    ({"precision": "dd2", "nt_precision": "dd"}, NotImplementedError, "item 12"),
    ({"gemm_backend": "int8"}, NotImplementedError, "Not carried over"),
    ({"assembly_precision": "f32", "precision": "dd"}, ValueError, "conflicts"),
    ({"chol_backend": "mixed"}, NotImplementedError, "Not carried over"),
])
def test_unported_options_raise(opts, exc, match):
    """The option values the port does not run raise NotImplementedError
    naming their ROADMAP item; a combination the JAX package rejects raises
    its ValueError."""
    p = ltt.load_problem(str(DATA / "theta1.dat-s"), device="cpu")
    with pytest.raises(exc, match=match):
        ltt.Solver(p, dict(PORT_OPTS, **opts), device="cpu")


@pytest.mark.parametrize("option", ["profile_dir", "timing"])
def test_item15_options_run(tmp_path, capsys, option):
    """``profile_dir`` and ``timing=2`` raised NotImplementedError until ROADMAP
    item 15 ported them; now they run (tests/test_torch_diagnostics.py holds
    what they print and write)."""
    opts = {"profile_dir": str(tmp_path)} if option == "profile_dir" else {"timing": 2, "verb": 1}
    p = ltt.load_problem(str(DATA / "control1.dat-s"), device="cpu")
    r = ltt.Solver(p, dict(PORT_OPTS, eDIMACS=1e-4, eigh_backend="xla", step_eig="exact",
                           **opts), device="cpu").solve()
    assert r.status == 1
    if option == "profile_dir":
        assert any(f.stat().st_size > 0 for f in tmp_path.glob("*.pt.trace.json"))
    else:
        assert "full fused step" in capsys.readouterr().out


def test_unported_problems_raise():
    """The LP cone (tru3) and sparse storage (control1 with an explicit nnz
    threshold) once raised NotImplementedError; both solve now.
    test_torch_lp.py and test_torch_sparse.py hold them against JAX."""
    r = ltt.solve_sdpa(str(DATA / "tru3.dat-s"), PORT_OPTS, device="cpu")
    assert r.status == 1 and abs(r.objective - 0.0625) <= 1e-6
    assert r.X_lin.shape == (72,) and abs(r.dual_objective - r.objective) <= 1e-6
    p = ltt.load_problem(str(DATA / "control1.dat-s"), {"datasparsity": 1000}, device="cpu")
    assert all(g.is_sparse for g in p.groups)
    r = ltt.solve(p, dict(PORT_OPTS, eDIMACS=1e-5), device="cpu")
    assert r.status == 1 and abs(r.objective - 17.78463) <= 1e-5 * 17.78463


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        ltt.load_problem(str(DATA / "theta1.dat-s"))  # default device is cuda
    p = ltt.load_problem(str(DATA / "theta1.dat-s"), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ltt.Solver(p, PORT_OPTS)
