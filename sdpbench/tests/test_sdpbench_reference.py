"""The plain reference accepts a correct CPU solve and rejects a perturbed
one (CPU)."""
import ast
import os

import numpy as np
import pytest

import sdpbench_cells as sc
import instance as I
import reference


@pytest.fixture(scope="module")
def solved():
    import loraine_tpu_torch as ltt

    inst = I.relabel(I.read_sdpa(sc.TRU3), I.request_rng(11, 0))
    p = ltt.problem_from_sdpa(I.to_program(inst, ltt.SDPAData), device="cpu")
    res = ltt.solve(p, {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "verb": 0}, device="cpu")
    assert res.status_name == "OPTIMAL"
    ans = {"X": res.X, "S": res.S, "y": res.y, "X_lin": res.X_lin, "objective": res.objective}
    return inst, ans, res


def test_reference_accepts_a_correct_solve(solved):
    inst, ans, res = solved
    j = reference.judge(inst, ans)
    assert j["dimacs"] < 1e-5
    assert j["infeas"] < 1e-12
    assert j["obj_gap"] < 1e-14
    # the program's own sum, whose err1/err3 are the residuals at the start
    # of the last iteration, is of the same size
    assert 0.5 < j["dimacs"] / res.dimacs < 2.0


@pytest.mark.parametrize("fault", ["X_scaled", "y_moved", "S_indefinite", "X_lin_negative",
                                   "objective_altered", "nan"])
def test_reference_rejects_a_perturbed_solve(solved, fault):
    inst, ans, _ = solved
    bad = {k: (list(v) if isinstance(v, list) else v) for k, v in ans.items()}
    if fault == "X_scaled":
        bad["X"] = [1.001 * x for x in ans["X"]]
    elif fault == "y_moved":
        bad["y"] = ans["y"] * (1 + 1e-6)
    elif fault == "S_indefinite":
        bad["S"] = [s - 1e-3 * np.eye(len(s)) for s in ans["S"]]
    elif fault == "X_lin_negative":
        bad["X_lin"] = ans["X_lin"] - 1e-3
    elif fault == "objective_altered":
        bad["objective"] = ans["objective"] * (1 + 1e-9)
    elif fault == "nan":
        bad["y"] = ans["y"].copy()
        bad["y"][0] = np.nan
    j = reference.judge(inst, bad)
    cell = sc.cell()
    limits = cell.limits()
    assert any(j[k] > limits[k] for k in ("dimacs", "infeas", "obj_gap")), j


def test_reference_takes_nothing_of_the_program():
    """reference.py and what it imports of the benchmark import neither the
    program nor JAX, compared by whole top-level name."""
    seen, todo = set(), ["reference"]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = os.path.join(sc.SDPBENCH, f"{mod}.py")
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("loraine_tpu_torch", "loraine_tpu", "jax", "torch"), (mod, n)
                if os.path.exists(os.path.join(sc.SDPBENCH, f"{top}.py")):
                    todo.append(top)
    assert seen == {"reference", "instance"}
