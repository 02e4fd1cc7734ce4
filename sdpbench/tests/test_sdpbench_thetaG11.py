"""The cells thetaG11.solve and tru9.library-eigh, their files, and the
plain step reference `plain_step.py` on small inputs (CPU)."""
import filecmp
import json
import os

import numpy as np
import pytest
import torch

import sdpbench_cells as sc
import harness
import instance as I
import plain_step

BENCH = json.load(open(os.path.join(sc.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("cell,config,options,libraries", [
    ("thetaG11.solve", "thetaG11", {}, ["jacobi"]),
    ("tru9.library-eigh", "tru9", {"eigh_backend": "mixed", "step_eig": "exact"}, []),
])
def test_the_cell_loads_with_its_files(cell, config, options, libraries):
    c = harness.load_cell(cell)
    assert c.chips == 1 and c.config["name"] == config
    assert set(c.workload) == set(harness.WORKLOAD_KEYS)
    assert c.workload["options"] == options and c.workload["libraries"] == libraries
    assert set(c.workload["limits"]) == {"infeas", "obj_gap"}
    assert c.options == {**c.config["options"], **options}
    for m in ("build_ms", "ipm_iters", "iter_ms", "step_mfu", "idle_share"):
        assert cell in next(x for x in BENCH["per_layer"] if x["name"] == m)["workloads"]
    jac = next(x for x in BENCH["per_layer"] if x["name"] == "jacobi_roofline")["workloads"]
    assert (cell in jac) == bool(libraries)


def test_thetaG11_configuration():
    c = harness.load_json(os.path.join(sc.SDPBENCH, "configs", "thetaG11.json"))
    assert set(c) == {"name", "source", "instance", "problem", "options", "guarantee",
                      "reduced", "assumed"}
    assert c["options"] == {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "datarank": -1, "verb": 0}
    assert c["guarantee"] == {"status": "OPTIMAL", "eDIMACS": 1e-5}
    assert c["reduced"] == c["assumed"] == []
    inst = I.read_sdpa(os.path.join(sc.ROOT, c["instance"]))
    assert inst.nvar == c["problem"]["nvar"] == 2401
    assert inst.block_sizes == c["problem"]["block_sizes"] == [801]


def test_the_instance_is_the_repository_copy():
    assert filecmp.cmp(os.path.join(sc.ROOT, "tests", "data", "thetaG11.dat-s"),
                       os.path.join(sc.SDPBENCH, "data", "thetaG11.dat-s"), shallow=False)


def test_a_request_is_written_as_the_harness_relabels_it(tmp_path):
    out = tmp_path / "req.dat-s"
    seed = 2**40 + 5
    assert plain_step.main(["request", "--workload", "tru9.library-eigh", "--seed", str(seed),
                            "--index", "2", "--out", str(out)]) == 0
    got = I.read_sdpa(str(out))
    want = I.relabel(I.read_sdpa(os.path.join(sc.SDPBENCH, "data", "tru9.dat-s")),
                     I.request_rng(seed, 2))
    assert got.nvar == want.nvar and got.block_sizes == want.block_sizes
    assert np.array_equal(got.c, want.c)
    for a, b in zip(got.blocks, want.blocks):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _spd(rng, n, cond):
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return torch.as_tensor(Q @ np.diag(np.geomspace(1.0, 1.0 / cond, n)) @ Q.T)


def test_nt_w_scales_s_to_x():
    rng = np.random.default_rng(0)
    X, S = _spd(rng, 12, 1e3), _spd(rng, 12, 1e4)
    W = plain_step.nt_w(X, S)
    assert torch.allclose(W @ S @ W, X, rtol=0, atol=1e-12)
    assert torch.allclose(W, W.T, rtol=0, atol=0)


def test_schur_is_the_trace_definition_in_any_blocking():
    """Rank-1 and dense constraints of SDPLIB theta1's first block, against
    tr(A_i W A_j W) one pair at a time."""
    inst = I.read_sdpa(sc.THETA1)
    rng = np.random.default_rng(1)
    m = inst.block_sizes[0]
    W = _spd(rng, m, 1e2)
    A = plain_step.dense_constraints(inst, 0, torch.float64, "cpu")
    full = A(0, inst.nvar)
    want = torch.einsum("ipq,qr,jrs,sp->ij", full, W, full, W)
    for chunk in (1, 7, inst.nvar):
        assert torch.allclose(plain_step.schur(W, A, inst.nvar, chunk), want, rtol=1e-13,
                              atol=1e-13 * float(want.abs().max()))


def test_steplength_is_the_largest_feasible_step():
    rng = np.random.default_rng(2)
    X = _spd(rng, 10, 1e2)
    D = torch.as_tensor(rng.standard_normal((10, 10)))
    dX = -(D @ D.T)  # a descent direction: the largest step is finite
    alpha, rule = plain_step.steplength(X, dX)
    lam = lambda a: float(torch.linalg.eigvalsh(X + a * dX)[0])  # noqa: E731
    if alpha < 1.0:
        assert abs(lam(alpha)) <= 1e-10 * float(torch.linalg.norm(X))
        assert lam(0.999 * alpha) > 0 > lam(1.001 * alpha)
        assert rule == min(1.0, plain_step.TAU * alpha)
    assert plain_step.steplength(X, X) == (1.0, 0.99)  # no eigenvalue below zero
