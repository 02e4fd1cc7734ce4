"""tests/test_robustness.py on loraine_tpu_torch: the same cases and
assertions, word for word, on the port with device='cpu' under the JAX CPU
run's modes (eigh_backend 'jacobi' below m = 192, 'mixed' from there;
step_eig 'exact'). `lt` here is `torch_cases.PORT_CPU`, which serves the
suite's calls from the port.
"""
import numpy as np
import pytest

from torch_cases import PORT_CPU as lt, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_float32_mode(data_dir):
    res = lt.solve_sdpa(
        str(data_dir / "theta1.dat-s"),
        {"kit": 0, "eDIMACS": 5e-3, "initpoint": 1, "verb": 0, "dtype": "float32", "maxit": 50},
    )
    # f32 can't reach tight DIMACS but must get the objective to ~1e-2
    assert res.status in (1, 4)
    np.testing.assert_allclose(res.objective, 23.0, rtol=5e-2)


def test_infeasible_problem_terminates():
    # y*I <= -I is infeasible for y real?? no: y <= -1 works; make truly
    # infeasible: y*0 <= -I  =>  0 <= -I impossible
    A = np.zeros((1, 4, 4))
    C = -np.eye(4)
    b = np.array([1.0])
    prob = lt.problem_from_dense([A], [C], b)
    res = lt.solve(prob, {"verb": 0, "maxit": 60})
    assert res.status != 1  # must not claim optimality


def test_unbounded_problem_terminates():
    # max y s.t. y * 0 <= I: unbounded above
    A = np.zeros((1, 4, 4))
    C = np.eye(4)
    b = np.array([1.0])
    prob = lt.problem_from_dense([A], [C], b)
    res = lt.solve(prob, {"verb": 0, "maxit": 60})
    assert res.status != 1


def test_tiny_1x1_sdp():
    # max y s.t. y <= 5 via 1x1 block
    A = np.ones((1, 1, 1))
    C = np.array([[5.0]])
    b = np.array([1.0])
    prob = lt.problem_from_dense([A], [C], b, pad_multiple=2)
    res = lt.solve(prob, {"verb": 0, "eDIMACS": 1e-8})
    assert res.status == 1
    np.testing.assert_allclose(res.y, [5.0], rtol=1e-6)


def test_duplicate_sdpa_entries(tmp_path):
    # duplicate COO entries must accumulate
    p = tmp_path / "dup.dat-s"
    p.write_text("1\n1\n2\n1.0\n0 1 1 1 1.0\n0 1 1 1 1.0\n1 1 1 1 1.0\n1 1 2 2 1.0\n")
    prob = lt.problem_from_sdpa(str(p))
    # C = -F0: F0[0,0] = 2.0 accumulated
    C = np.asarray(prob.groups[0].C[0])
    assert C[0, 0] == -2.0
