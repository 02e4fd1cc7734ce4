"""The POEMA-JSON, MAT and raw-dict entries, `solve_json`, `DEFAULT_OPTIONS`,
the public names and the CLI of loraine_tpu_torch against the JAX package,
on the CPU.

- The readers and the writer: the same files give the same dicts (exact),
  and the port's writer writes the JAX writer's bytes.
- `problem_from_dict`: the same dict gives the same group arrays in both
  packages (the JAX problem carried over by `convert.problem_from_numpy`),
  exactly: the lowering is the same numpy code.
- `solve_json`: both packages under EXACT_MODES reach the same status and
  iteration count, objectives within 1e-8 relative; under the port's own
  'auto' (the plain versions of B1 and B2 here) theta1 is OPTIMAL at 23.
- The CLI with ``--device cpu`` on an SDPA and a POEMA-JSON file.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from test_poema_io import _dict_from_sdpa
from torch_cases import EXACT_MODES, assert_same_problem, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DATA = pathlib.Path(__file__).parent / "data"
REPO = pathlib.Path(__file__).resolve().parents[1]
OPTS = {"eDIMACS": 1e-6, "initpoint": 1, "verb": 0}


def _internal_dict():
    # test_api.py's tiny SDP in the internal (pre-negated) convention
    return {"nvar": 1, "As": [np.eye(2)[None]], "Cs": [np.diag([2.0, 3.0])],
            "b": np.array([1.0])}


def _maxcut_dict():
    # a max-cut in the internal convention: rank-1 data A_j = E_jj
    W = np.array([[0, 1, 5, 0], [1, 0, 0, 9], [5, 0, 0, 2], [0, 9, 2, 0]], dtype=float)
    L = np.diag(W.sum(1)) - W
    return {"nvar": 4, "As": [np.stack([np.diag(e) for e in np.eye(4)])], "Cs": [-L / 4],
            "b": np.ones(4)}


def _dict(name):
    if name in ("internal", "maxcut"):
        return _internal_dict() if name == "internal" else _maxcut_dict()
    return _dict_from_sdpa(DATA / f"{name}.dat-s")


@pytest.mark.parametrize("name,datarank", [("theta1", 0), ("vib3", 0), ("tru3", 0),
                                           ("control1", 0), ("internal", 0), ("maxcut", -1)])
def test_problem_from_dict_same_arrays(name, datarank):
    d = _dict(name)
    pt = ltt.problem_from_dict(d, datarank=datarank, device="cpu")
    pj = lt.problem_from_dict(d, datarank=datarank)
    assert all(g.is_rank1 == (datarank == -1) for g in pt.groups)
    assert_same_problem(pt, pj)


def test_problem_from_dict_storage_as_sdpa():
    """tru9's dict (dense A, 0.55 GB) gets the storage `load_problem` picks
    from the .dat-s file: the same modeled-cost 'auto' rule gives sparse
    COO with 16 slots, so `solve_json` on tru9 runs the sparse path."""
    pt = ltt.problem_from_dict(_dict("tru9"), device="cpu")
    ps = ltt.load_problem(str(DATA / "tru9.dat-s"), device="cpu")
    assert [(g.m, g.is_sparse, tuple(g.Avals.shape)) for g in pt.groups] == \
        [(g.m, g.is_sparse, tuple(g.Avals.shape)) for g in ps.groups] == [(152, True, (1, 3240, 16))]


@pytest.mark.parametrize("name", ["theta1", "vib3"])
def test_poema_roundtrip_same_dicts(tmp_path, name):
    """The port's writer writes the JAX writer's bytes, and both readers read
    the same dict from it."""
    d = _dict(name)
    pt_path, pj_path = tmp_path / "port.json", tmp_path / "jax.json"
    ltt.write_poema_json(str(pt_path), d)
    lt.write_poema_json(str(pj_path), d)
    assert pt_path.read_bytes() == pj_path.read_bytes()
    dt, dj = ltt.read_poema_json(str(pj_path)), lt.read_poema_json(str(pj_path))
    assert dt.keys() == dj.keys()
    for k in dj:
        if isinstance(dj[k], list):
            assert all(np.array_equal(a, b) for a, b in zip(dt[k], dj[k])), k
        else:
            assert np.array_equal(np.asarray(dt[k]), np.asarray(dj[k])), k
    assert_same_problem(ltt.problem_from_dict(dt, device="cpu"), lt.problem_from_dict(dj))


def test_mat_reader_same_dict(tmp_path):
    scipy_io = pytest.importorskip("scipy.io")
    d = _dict_from_sdpa(DATA / "theta1.dat-s")
    mat = {"nvar": float(d["nvar"]), "nlmi": float(d["nlmi"]),
           "msizes": np.asarray(d["msizes"], dtype=np.float64), "c": d["c"],
           "A": np.empty((1,), dtype=object), "C": np.empty((1,), dtype=object),
           "b_const": 0.0, "nlin": 0.0}
    mat["A"][0], mat["C"][0] = d["A"][0], d["C"][0]
    path = str(tmp_path / "theta1.mat")
    scipy_io.savemat(path, {"d": mat})
    dt, dj = ltt.read_mat_dict(path), lt.read_mat_dict(path)
    assert dt.keys() == dj.keys()
    assert np.array_equal(dt["A"][0], dj["A"][0]) and np.array_equal(dt["C"][0], dj["C"][0])
    assert_same_problem(ltt.problem_from_dict(dt, device="cpu"), lt.problem_from_dict(dj))


@pytest.mark.parametrize("name", ["theta1", "vib3"])
def test_solve_json_matches_jax(tmp_path, name):
    path = str(tmp_path / f"{name}.json")
    lt.write_poema_json(path, _dict(name))
    opts = dict(OPTS, **EXACT_MODES)
    rj, rt = lt.solve_json(path, opts), ltt.solve_json(path, opts, device="cpu")
    assert rt.status == rj.status == 1
    assert rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= 1e-8 * abs(rj.objective)


def test_solve_json_port_auto(tmp_path):
    """The kernel route from the JSON entry: the port's 'auto' runs the plain
    versions of B1 and B2 on the CPU."""
    path = str(tmp_path / "theta1.json")
    ltt.write_poema_json(path, _dict("theta1"))
    r = ltt.solve_json(path, OPTS, device="cpu")
    assert r.status == 1 and abs(r.objective - 23.0) < 1e-4


def test_problem_from_dict_conventions_solve():
    """test_api.py's two dict conventions through the port: y* = 2."""
    p1 = ltt.problem_from_dict(_internal_dict(), device="cpu")
    p2 = ltt.problem_from_dict({"nvar": 1, "A": [-np.eye(2)[None]], "C": [-np.diag([2.0, 3.0])],
                                "c": [-1.0]}, device="cpu")
    for p in (p1, p2):
        r = ltt.solve(p, {"verb": 0, "eDIMACS": 1e-8}, device="cpu")
        assert r.status == 1
        np.testing.assert_allclose(r.y, [2.0], rtol=1e-6)


def test_default_options_and_public_names():
    assert dataclasses.asdict(ltt.DEFAULT_OPTIONS) == dataclasses.asdict(lt.DEFAULT_OPTIONS)
    assert ltt.__all__ == lt.__all__
    assert all(hasattr(ltt, name) for name in ltt.__all__)


@pytest.mark.parametrize("kind", ["sdpa", "json"])
def test_cli_device_cpu(tmp_path, kind):
    path = str(DATA / "theta1.dat-s")
    if kind == "json":
        path = str(tmp_path / "theta1.json")
        ltt.write_poema_json(path, _dict("theta1"))
    out = subprocess.run(
        [sys.executable, "-m", "loraine_tpu_torch", "solve", path, "--kit", "0",
         "--eDIMACS", "1e-6", "--initpoint", "1", "--verb", "0", "--json", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    payload = json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1])
    assert payload["status"] == "OPTIMAL"
    np.testing.assert_allclose(payload["objective"], 23.0, rtol=1e-6)
