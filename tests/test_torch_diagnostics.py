"""The diagnostics of loraine_tpu_torch against the JAX package, on the CPU:
`profile_phases` (`utils/diagnostics.py`) returns the JAX package's row
names on kit=0 and kit=1 (on the CPU neither package adds the CG-kernel
row), ``timing=2`` prints the table, ``profile_dir`` writes a trace, and
`utils/flops.py` counts the JAX package's flops on theta1, maxG11 (rank-1)
and tru9 (sparse + LP), exactly; `utilization` divides by the H100's f64
peak.
"""
import glob
import json
import pathlib

import numpy as np
import pytest

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from loraine_tpu.utils import flops as jflops
from loraine_tpu.utils.diagnostics import profile_phases as jax_profile_phases
from loraine_tpu_torch.utils import flops as tflops
from loraine_tpu_torch.utils.diagnostics import format_phases, profile_phases
from torch_cases import EXACT_MODES, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DATA = pathlib.Path(__file__).parent / "data"
KIT1 = {"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-6, "initpoint": 1,
        "verb": 0}


def _small(pkg, **kw):
    # tests/test_api.py::test_profile_phases_returns_named_sections' problem
    rng = np.random.default_rng(3)
    n, m = 8, 6
    A = rng.standard_normal((n, m, m))
    A = A + np.swapaxes(A, -1, -2)
    return pkg.problem_from_dense([A], [np.eye(m) * m], rng.standard_normal(n), pad_multiple=2,
                                  **kw)


@pytest.mark.parametrize("case", ["kit0", "kit1"])
def test_profile_phases_rows_as_jax(case):
    if case == "kit0":
        pj, pt, opts = _small(lt), _small(ltt, device="cpu"), {"verb": 0}
    else:
        path = str(DATA / "control1.dat-s")
        pj, pt, opts = lt.problem_from_sdpa(path), ltt.problem_from_sdpa(path, device="cpu"), KIT1
    tj = jax_profile_phases(pj, opts, repeats=1, iters=1)
    tt = profile_phases(pt, opts, repeats=1, iters=1)
    assert list(tt) == list(tj)
    assert all(v > 0 for v in tt.values())
    table = format_phases(tt, "cpu")
    assert "ground truth" in table and "CPU times" in table


def test_steplength_row_times_the_steps_bound(monkeypatch):
    """Under step_eig='exact' with eigh_backend='pallas' the step bounds
    with B2 (`eig_bounds_jacobi`, `ipm/step.py:_bound_fns`): the "find_step
    spectral" row times that bound, and no B1 seed (`eigh_jacobi_f32`)."""
    import loraine_tpu_torch.ipm.step as S
    import loraine_tpu_torch.ops.eigh as E
    from loraine_tpu_torch.utils import diagnostics as D

    calls, row = [], {"on": False}

    def counted(name, fn):
        def wrapped(*a, **k):
            if row["on"]:
                calls.append(name)
            return fn(*a, **k)
        return wrapped

    real = D._timed

    def timed(fn, *a, **k):
        row["on"] = fn.__name__ == "steplen"
        try:
            return real(fn, *a, **k)
        finally:
            row["on"] = False

    monkeypatch.setattr(S, "eig_bounds_jacobi", counted("B2", S.eig_bounds_jacobi))
    monkeypatch.setattr(E, "eigh_jacobi_f32", counted("B1", E.eigh_jacobi_f32))
    monkeypatch.setattr(D, "_timed", timed)
    tt = profile_phases(_small(ltt, device="cpu"),
                        {"verb": 0, "step_eig": "exact", "eigh_backend": "pallas"},
                        repeats=1, iters=1)
    assert "find_step spectral, group0 (predictor)" in tt
    assert calls and set(calls) == {"B2"}, calls


def test_timing2_prints_phase_table(capsys):
    """tests/test_api.py::test_timing2_prints_phase_breakdown on the port
    (on control1: a smaller solve than theta1 on the CPU)."""
    r = ltt.solve_sdpa(str(DATA / "control1.dat-s"), {"eDIMACS": 1e-4, "timing": 2, "verb": 1},
                       device="cpu")
    out = capsys.readouterr().out
    assert r.status == 1
    assert "per-phase CPU times" in out
    for phase in ("prepare_W", "Schur assembly", "H Cholesky", "find_step spectral",
                  "full fused step"):
        assert phase in out, f"missing phase row: {phase}"


def test_profile_dir_writes_trace(tmp_path):
    r = ltt.solve_sdpa(str(DATA / "control1.dat-s"),
                       {"eDIMACS": 1e-5, "verb": 0, "profile_dir": str(tmp_path), **EXACT_MODES},
                       device="cpu")
    assert r.status == 1
    (trace,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    events = json.load(open(trace))["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("name,kit,datarank", [("theta1", 0, 0), ("theta1", 1, 0),
                                               ("maxG11", 0, -1), ("tru9", 0, 0)])
def test_iteration_flops_as_jax(name, kit, datarank):
    path = str(DATA / f"{name}.dat-s")
    pj = lt.problem_from_sdpa(path, datarank=datarank)
    pt = ltt.problem_from_sdpa(path, datarank=datarank, device="cpu")
    assert [tflops.group_stats(g) for g in pt.groups] == [jflops.group_stats(g) for g in pj.groups]
    assert tflops.iteration_flops(pt, kit, 7.5) == jflops.iteration_flops(pj, kit, 7.5)


def test_utilization_uses_h100_peak():
    assert tflops.H100_F64_PEAK_FLOPS == 67.0e12
    assert tflops.utilization(6.7e12, 1.0) == pytest.approx(0.1, rel=1e-15)
    assert tflops.utilization(1.0, 0.0) == 0.0
    assert not hasattr(tflops, "F64_PEAK_FLOPS")
