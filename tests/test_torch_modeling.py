"""The modeling layer (`modeling.py`) and the model families (`models/`) of
loraine_tpu_torch against the JAX package, on the CPU.

- Lowering: every example model of tests/test_modeling.py lowers to the
  same arrays in both packages (`problem_from_dense`'s arguments, exactly:
  the lowering is the same numpy code), and each problem function of
  `models/` gives the same group arrays (the JAX problem carried over by
  `convert.problem_from_numpy`).
- Solves under EXACT_MODES in both packages: the same status and iteration
  count, objectives within 1e-8 relative; `solve_maxcut` the same
  partition; `correlation_bounds` and `minimum_distortion` within 1e-8.
- Under the port's own 'auto' (the plain versions of B1 and B2 here): one
  `Model.solve` and each model family at the JAX suite's anchors.
"""
import numpy as np
import pytest

import loraine_tpu as lt
import loraine_tpu.models as jm
import loraine_tpu.problem as jproblem
import loraine_tpu_torch as ltt
import loraine_tpu_torch.models as tm
import loraine_tpu_torch.problem as tproblem
from loraine_tpu.modeling import Model as JModel, dot as jdot, trace as jtrace
from loraine_tpu_torch.modeling import Model as TModel, dot as tdot, trace as ttrace
from torch_cases import EXACT_MODES, assert_same_problem, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W4 = np.array([[0, 1, 5, 0], [1, 0, 0, 9], [5, 0, 0, 2], [0, 9, 2, 0]], dtype=float)
D4 = np.array([[0.0, 1, 1, 1], [1, 0, 2, 2], [1, 2, 0, 2], [1, 2, 2, 0]])


def _maxcut(Model, dot, _trace, sense=None):
    N = 4
    L = np.diag(W4 @ np.ones(N)) - W4
    m = Model()
    X = m.psd_var(N)
    for i in range(N):
        m.add_constraint(X[i, i] == 1)
    m.maximize(0.25 * dot(L, X))
    return m, {"eDIMACS": 1e-7}


def _correlation(Model, dot, _trace, sense="max"):
    m = Model()
    X = m.psd_var(3)
    for i in range(3):
        m.add_constraint(X[i, i] == 1)
    m.add_constraint(X[0, 1] >= -0.2)
    m.add_constraint(X[0, 1] <= -0.1)
    m.add_constraint(X[1, 2] >= 0.4)
    m.add_constraint(X[1, 2] <= 0.5)
    (m.maximize if sense == "max" else m.minimize)(X[0, 2])
    return m, {"eDIMACS": 1e-8, "initpoint": 1}


def _distortion(Model, dot, _trace, sense=None):
    m = Model()
    c2 = m.nonneg_var("c2")
    Q = m.psd_var(4)
    m.add_constraint(c2 >= 1)
    for i in range(4):
        for j in range(i + 1, 4):
            g = Q[i, i] + Q[j, j] - 2 * Q[i, j]
            m.add_constraint(g >= D4[i, j] ** 2)
            m.add_constraint(g - D4[i, j] ** 2 * c2 <= 0)
    m.add_constraint(Q[0, 0] == 0)
    m.minimize(c2)
    return m, {"eDIMACS": 1e-8, "initpoint": 1}


def _lp_duals(Model, dot, _trace, sense=None):
    m = Model()
    x = m.free_var("x")
    m.add_constraint(x >= 1)
    m.add_constraint(x <= 2)
    m.maximize(2 * x)
    return m, {"eDIMACS": 1e-9}


def _trace_model(Model, dot, trace, sense=None):
    m = Model()
    X = m.psd_var(3)
    m.add_constraint(trace(X) == 1)
    m.maximize(dot(np.ones((3, 3)), X))
    return m, {"eDIMACS": 1e-8}


# tests/test_modeling.py's models and their anchors
MODELS = {
    "maxcut": (_maxcut, None, 17.0),
    "corr_max": (_correlation, "max", 0.8719210472),
    "corr_min": (_correlation, "min", -0.9779977649),
    "distortion": (_distortion, None, 4.0 / 3.0),
    "lp_duals": (_lp_duals, None, 4.0),
    "trace": (_trace_model, None, 3.0),
}


def _lowered(monkeypatch, module, build, sense):
    """(problem_from_dense's arguments, the ModelResult) of one Model.solve."""
    seen = {}
    orig = module.problem_from_dense

    def spy(As, Cs, b, **kw):
        seen.update(As=As, Cs=Cs, b=b, **kw)
        return orig(As, Cs, b, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(module, "problem_from_dense", spy)
        Model, dot, trace = (JModel, jdot, jtrace) if module is jproblem else (TModel, tdot,
                                                                             ttrace)
        m, opts = build(Model, dot, trace, sense)
        opts = dict(opts, **EXACT_MODES)
        res = m.solve(opts) if module is jproblem else m.solve(opts, device="cpu")
    return seen, res


@pytest.mark.parametrize("name", list(MODELS))
def test_model_lowers_and_solves_as_jax(monkeypatch, name):
    build, sense, anchor = MODELS[name]
    lj, rj = _lowered(monkeypatch, jproblem, build, sense)
    lt_, rt = _lowered(monkeypatch, tproblem, build, sense)
    assert lt_.pop("device") == "cpu"
    assert lt_.keys() == lj.keys()
    for k in lj:
        if isinstance(lj[k], list):
            assert len(lt_[k]) == len(lj[k]) and all(
                np.array_equal(a, b) for a, b in zip(lt_[k], lj[k])), k
        elif isinstance(lj[k], np.ndarray) or lj[k] is None:
            assert (lt_[k] is None and lj[k] is None) or np.array_equal(lt_[k], lj[k]), k
        else:
            assert lt_[k] == lj[k], k
    assert rt.status == rj.status == 1
    assert rt.raw.iterations == rj.raw.iterations
    assert abs(rt.objective - rj.objective) <= 1e-8 * abs(rj.objective)
    np.testing.assert_allclose(rt.objective, anchor, rtol=1e-4, atol=1e-4)


def test_model_solve_port_auto():
    """The kernel route from the modeling layer: test_modeling.py's max-cut
    under the port's 'auto'."""
    m, opts = _maxcut(TModel, tdot, ttrace)
    res = m.solve(opts, device="cpu")
    assert res.status == 1
    np.testing.assert_allclose(res.objective, 17.0, rtol=1e-6)
    np.testing.assert_allclose(np.diag(res.value(m._psd[0])), 1.0, atol=1e-6)


def test_lp_duals_port():
    """test_modeling.py's LP with shadow prices 0 and 2, on the port."""
    m = TModel()
    x = m.free_var("x")
    c1 = m.add_constraint(x >= 1)
    c2 = m.add_constraint(x <= 2)
    m.maximize(2 * x)
    res = m.solve({"eDIMACS": 1e-9}, device="cpu")
    assert res.status == 1
    np.testing.assert_allclose(res.value(x), 2.0, rtol=1e-6)
    assert abs(res.dual(c1)) < 1e-6
    np.testing.assert_allclose(abs(res.dual(c2)), 2.0, rtol=1e-5)


# ---- models/


def _model_problems():
    rng = np.random.default_rng(29)
    W = np.triu(rng.random((12, 12)) < 0.4, 1) * rng.integers(1, 6, (12, 12))
    W = (W + W.T).astype(float)
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)]
    b, C_lin, d_lin = np.array([2.0]), np.array([[-1.0, 1.0]]), np.array([-1.0, 2.0])
    return {
        "maxcut": (lambda m, **k: m.maxcut_problem(W, **k), W),
        "maxcut_rank1": (lambda m, **k: m.maxcut_problem(W, datarank=-1, **k), W),
        "theta_c5": (lambda m, **k: m.lovasz_theta_problem(5, edges, **k), None),
        "lp": (lambda m, **k: m.lp_problem(b, C_lin, d_lin, **k), None),
    }


@pytest.mark.parametrize("name", ["maxcut", "maxcut_rank1", "theta_c5", "lp"])
def test_model_problems_same_arrays_and_solve(name):
    build, _ = _model_problems()[name]
    pj, pt = build(jm), build(tm, device="cpu")
    assert_same_problem(pt, pj)
    opts = {"kit": 0, "eDIMACS": 1e-8, "verb": 0, "initpoint": 1, **EXACT_MODES}
    rj, rt = lt.solve(pj, opts), ltt.solve(pt, opts, device="cpu")
    assert rt.status == rj.status == 1
    assert rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= 1e-8 * abs(rj.objective)


def test_solve_maxcut_same_partition():
    W = _model_problems()["maxcut"][1]
    Sj, Tj, vj = jm.solve_maxcut(W, dict(EXACT_MODES))
    St, Tt, vt = tm.solve_maxcut(W, dict(EXACT_MODES), device="cpu")
    assert (St, Tt) == (Sj, Tj)
    assert abs(vt - vj) <= 1e-8 * abs(vj)


def test_correlation_and_distortion_match_jax():
    lo_j, hi_j = jm.correlation_bounds(dict(EXACT_MODES))
    lo_t, hi_t = tm.correlation_bounds(dict(EXACT_MODES), device="cpu")
    assert abs(lo_t - lo_j) <= 1e-8 * abs(lo_j) and abs(hi_t - hi_j) <= 1e-8 * abs(hi_j)
    c2_j, Q_j = jm.minimum_distortion(options=dict(EXACT_MODES))
    c2_t, Q_t = tm.minimum_distortion(options=dict(EXACT_MODES), device="cpu")
    assert abs(c2_t - c2_j) <= 1e-8 * c2_j
    np.testing.assert_allclose(Q_t, Q_j, atol=1e-8)


def test_models_port_auto_anchors():
    """tests/test_models.py's anchors through the port's 'auto' route."""
    S, T, val = tm.solve_maxcut(W4, device="cpu")
    assert sorted([tuple(sorted(S)), tuple(sorted(T))]) == [(0, 3), (1, 2)]
    np.testing.assert_allclose(val, 17.0, rtol=1e-5)
    lower, upper = tm.correlation_bounds(device="cpu")
    np.testing.assert_allclose(lower, -0.9779977649, rtol=1e-6)
    np.testing.assert_allclose(upper, 0.8719210472, rtol=1e-6)
    c2, Q = tm.minimum_distortion(device="cpu")
    np.testing.assert_allclose(c2, 4.0 / 3.0, atol=1e-4)
    res = ltt.solve(tm.lp_problem(np.array([2.0]), np.array([[-1.0, 1.0]]),
                                  np.array([-1.0, 2.0]), device="cpu"),
                    {"kit": 0, "eDIMACS": 1e-8, "verb": 0}, device="cpu")
    assert res.status == 1
    np.testing.assert_allclose(-res.objective, 4.0, rtol=1e-6)
    np.testing.assert_allclose(res.X_lin, [0.0, 2.0], atol=1e-6)
    res = ltt.solve(tm.lovasz_theta_problem(5, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)],
                                            device="cpu"),
                    {"kit": 0, "eDIMACS": 1e-8, "verb": 0, "initpoint": 1}, device="cpu")
    assert res.status == 1
    np.testing.assert_allclose(res.objective, np.sqrt(5.0), rtol=1e-6)
