"""The control and the faults come out as not correct (CPU, at a size a
test run holds).

The control is the program's own float32 path (`control.py`): it has to
fail one of the numbers compared while the program's float64 runs pass
them all. The faults are planted under the timed path of a whole run
(`harness.run_cell` past its look for a card): a step that returns its
state unchanged, and an answer altered where the solver produces it, in
every solve or in one of a window's three (held in float32). A
solve holds no batch whose mean could be taken over half of it, and a
one-chip cell no exchange between chips, so those faults do not apply."""
import json
import os
import time

import numpy as np
import pytest

import sdpbench_cells as sc
import control
import harness

BENCH = json.load(open(os.path.join(sc.ROOT, "BENCHMARK.json")))


def test_control_fails_where_the_program_passes():
    recs = list(control.readings(sc.cell(), "cpu", [2**35 + 1], 1.0, [2**35 + 2], 2,
                                 log=lambda s: None))
    prog = [r for r in recs if r["side"] == "program"]
    ctrl = [r for r in recs if r["side"].startswith("control")]
    assert prog and ctrl
    assert all(r["passes"] for r in prog), prog
    assert not any(r["passes"] for r in ctrl), ctrl


def _run(requests=2):
    return harness.run_cell(sc.cell(), 2**33 + 9, 600.0, False, "cpu", time.perf_counter(), BENCH,
                            log=lambda s: None, max_requests=requests)


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == 2
    assert list(out)[-3] == "checks"  # the numbers compared close the result's line


def test_fault_step_returns_its_state_unchanged(monkeypatch):
    import loraine_tpu_torch.ipm.solver as solver

    real = solver.step

    def stuck(problem, state, *args, **kw):
        _, stats = real(problem, state, *args, **kw)
        return state, stats

    monkeypatch.setattr(solver, "step", stuck)
    out = _run()
    assert not out["correct"]
    assert out["failed"] == out["attempted"] == 2


@pytest.mark.parametrize("what", ["y", "objective"])
def test_fault_answer_altered_where_produced(monkeypatch, what):
    import loraine_tpu_torch.ipm.solver as solver

    real = solver.Solver._extract

    def altered(self, *args, **kw):
        res = real(self, *args, **kw)
        if what == "y":
            res.y = res.y.copy()
            res.y[np.argmax(np.abs(res.y))] *= 1 + 1e-6
        else:
            res.objective *= 1 + 1e-9
        return res

    monkeypatch.setattr(solver.Solver, "_extract", altered)
    out = _run()
    assert not out["correct"]
    assert out["failed"] == 0  # the statuses still say OPTIMAL: the reference catches it


def test_fault_one_answer_in_three_held_in_float32(monkeypatch):
    """A minority of the window's answers at a lower precision, each still
    OPTIMAL with its objective: the worst infeasibility catches it."""
    import loraine_tpu_torch.ipm.solver as solver

    real = solver.Solver._extract
    calls = []

    def f32(a):
        return None if a is None else np.asarray(a, np.float32).astype(np.float64)

    def sometimes_f32(self, *args, **kw):
        res = real(self, *args, **kw)
        calls.append(1)
        if len(calls) == 3:  # the warm solve is the first; this is the window's second
            res.X, res.S = [f32(x) for x in res.X], [f32(v) for v in res.S]
            res.y, res.X_lin = f32(res.y), f32(res.X_lin)
            # the objective as the program computes it, from the rounded y
            res.objective = float(-np.dot(self.problem.b.cpu().numpy(), res.y)
                                  + self.problem.b_const)
        return res

    monkeypatch.setattr(solver.Solver, "_extract", sometimes_f32)
    out = _run(3)
    assert len(calls) == 4 and out["attempted"] == 3 and out["failed"] == 0
    assert not out["correct"]
    checks = out["checks"]
    assert checks["infeas"]["value"] > checks["infeas"]["limit"]
    assert checks["obj_gap"]["value"] <= checks["obj_gap"]["limit"]  # infeas alone catches it
