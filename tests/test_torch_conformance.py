"""tests/test_conformance.py on loraine_tpu_torch: the same cases and
assertions, word for word, on the port with device='cpu' under the JAX CPU
run's modes (eigh_backend 'jacobi' below m = 192, 'mixed' from there;
step_eig 'exact'; a config's own eigen or step mode wins). `lt` here is
`torch_cases.PORT_CPU`, which serves the suite's calls from the port; the
data and the KKT check are the JAX suite's own helpers.
"""
import numpy as np
import pytest

from torch_cases import PORT_CPU as lt, one_torch_thread  # noqa: F401

from test_conformance import _check_kkt, _random_feasible_sdp

pytestmark = pytest.mark.usefixtures("one_torch_thread")


CONFIGS = [
    {"kit": 0, "initpoint": 0},
    {"kit": 0, "initpoint": 1},
    {"kit": 0, "initpoint": 1, "storage": "sparse"},
    {"kit": 1, "preconditioner": 1, "initpoint": 1},
    {"kit": 1, "preconditioner": 2, "initpoint": 0},
    {"kit": 1, "preconditioner": 0, "initpoint": 1},
    {"kit": 0, "initpoint": 1, "nt_method": "svd", "eigh_backend": "xla"},
    {"kit": 0, "initpoint": 1, "step_eig": "chol"},
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=[str(i) for i in range(len(CONFIGS))])
@pytest.mark.parametrize("seed", [0, 1])
def test_kkt_conformance(cfg, seed):
    cfg = dict(cfg)
    storage = cfg.pop("storage", "auto")
    data = _random_feasible_sdp(seed)
    As, Cs, b, C_lin, d_lin = data
    prob = lt.problem_from_dense(As, Cs, b, C_lin=C_lin, d_lin=d_lin, storage=storage)
    eps = 1e-7 if cfg.get("kit", 0) == 0 else 1e-5
    res = lt.solve(prob, {**cfg, "eDIMACS": eps, "verb": 0})
    assert res.status == 1, f"status {res.status_name}"
    _check_kkt(data, res, max(eps * 10, 1e-6))


def test_no_lp_cone_conformance():
    data = _random_feasible_sdp(7, nlin=0)
    As, Cs, b, C_lin, d_lin = data
    prob = lt.problem_from_dense(As, Cs, b)
    res = lt.solve(prob, {"eDIMACS": 1e-7, "verb": 0, "initpoint": 1})
    assert res.status == 1
    _check_kkt(data, res, 1e-6)
