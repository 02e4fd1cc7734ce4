"""The port's trace spans (`loraine_tpu_torch/utils/timers.py:span`) on the
CPU: a profiled solve of SDPLIB tru3 holds one ``ltt.step`` an iteration
inside its ``ltt.solve``, every step holds the step's phases, the
eigen-work sits under the NT scaling and the steplengths, the build's
phases sit under ``ltt.build``, and with no profiler a span is one shared
null context that records nothing."""
import contextlib
import glob
import gzip
import os

import pytest
import torch

import loraine_tpu_torch as ltt
from loraine_tpu_torch.utils import timers

HERE = os.path.dirname(os.path.abspath(__file__))
TRU3 = os.path.join(HERE, "data", "tru3.dat-s")
OPTS = {"kit": 0, "eDIMACS": 1e-7, "initpoint": 1, "verb": 0}
STEP_PHASES = ("ltt.nt", "ltt.residuals", "ltt.schur", "ltt.factor", "ltt.schur_solve",
               "ltt.steplen", "ltt.corrector", "ltt.update", "ltt.stats")


def _spans(prof):
    """(name, start, end) of every ``ltt.`` range on the host."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("ltt.")]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _profiled(opts):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        problem = ltt.problem_from_sdpa(TRU3, device="cpu")
        res = ltt.solve(problem, opts, device="cpu")
    return res, _spans(prof)


@pytest.fixture(scope="module")
def solved():
    return _profiled(OPTS)


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_span_off_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range was recorded for {name} with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch._C._autograd._profiler_enabled()
    a, b = timers.span("step"), timers.span("eig")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a:
        pass


def test_span_on_records_under_its_prefix():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timers.span("outer"):
            with timers.span("inner"):
                torch.ones(4).sum()
    spans = _spans(prof)
    assert sorted(s[0] for s in spans) == ["ltt.inner", "ltt.outer"]
    assert _inside(_named(spans, "ltt.inner")[0], _named(spans, "ltt.outer")[0])


def test_phase_timer_opens_its_span():
    t = timers.PhaseTimer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.phase("ipm step", "step"):
            pass
        with t.phase("other"):
            pass
    assert sorted(s[0] for s in _spans(prof)) == ["ltt.other", "ltt.step"]
    assert t.counts == {"ipm step": 1, "other": 1}


def test_one_step_span_an_iteration_inside_the_solve(solved):
    res, spans = solved
    assert res.status == 1
    steps = _named(spans, "ltt.step")
    (solve,) = _named(spans, "ltt.solve")
    assert len(steps) == res.iterations
    assert all(_inside(s, solve) for s in steps)
    for name in ("ltt.init", "ltt.result"):
        (one,) = _named(spans, name)
        assert _inside(one, solve)


@pytest.mark.parametrize("phase", STEP_PHASES)
def test_every_step_holds_the_phase(solved, phase):
    _, spans = solved
    found = _named(spans, phase)
    for step in _named(spans, "ltt.step"):
        assert any(_inside(s, step) for s in found), f"a step without {phase}"
    # and no phase of the step outside a step
    assert all(any(_inside(s, step) for step in _named(spans, "ltt.step")) for s in found)


def test_two_solves_and_two_steplengths_a_step(solved):
    res, spans = solved
    for name in ("ltt.schur_solve", "ltt.steplen"):
        assert len(_named(spans, name)) == 2 * res.iterations


def test_eig_under_the_nt_scaling_and_the_steplengths(solved):
    _, spans = solved
    eig = _named(spans, "ltt.eig")
    for parent in ("ltt.nt", "ltt.steplen"):
        assert any(any(_inside(e, p) for p in _named(spans, parent)) for e in eig), parent
    assert all(any(_inside(e, p) for p in _named(spans, "ltt.nt") + _named(spans, "ltt.steplen"))
               for e in eig)


@pytest.mark.parametrize("child", ["ltt.build.factors", "ltt.build.layout", "ltt.build.upload",
                                   "ltt.build.lp"])
def test_build_phases_inside_the_build(solved, child):
    _, spans = solved
    (build,) = _named(spans, "ltt.build")
    (one,) = _named(spans, child)
    assert _inside(one, build)
    assert not any(_inside(build, s) for s in _named(spans, "ltt.solve"))


def test_no_lp_span_without_an_lp_cone():
    """theta1 has no diagonal block, so its build opens no ``ltt.build.lp``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        problem = ltt.problem_from_sdpa(os.path.join(HERE, "data", "theta1.dat-s"), device="cpu")
    spans = _spans(prof)
    assert problem.nlin == 0 and problem.C_lin is None and problem.C_lin_row_norms is None
    assert _named(spans, "ltt.build.upload") and not _named(spans, "ltt.build.lp")


def test_cg_path_marks_its_set_up_as_the_schur_phase():
    res, spans = _profiled({"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5,
                            "tol_cg_min": 1e-6, "initpoint": 1, "verb": 0})
    assert res.status == 1
    assert len(_named(spans, "ltt.schur")) == res.iterations
    assert not _named(spans, "ltt.factor")
    assert len(_named(spans, "ltt.schur_solve")) == 2 * res.iterations


def test_profile_dir_trace_holds_the_step_spans(tmp_path):
    problem = ltt.problem_from_sdpa(TRU3, device="cpu")
    res = ltt.solve(problem, dict(OPTS, profile_dir=str(tmp_path)), device="cpu")
    assert res.status == 1
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json*"))
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    assert text.count('"ltt.step"') == res.iterations
    assert '"ltt.solve"' in text and '"ltt.eig"' in text
