"""The precision tiers of loraine_tpu_torch ('dd' and 'dd2') against the JAX
package, on the CPU (`loraine_tpu/ipm/step.py` dd branches;
tests/test_precision.py).

(a) One kit=0 step at 'dd', one at 'dd2' and one at 'dd2' with
nt_precision='dd' (the native dd NT scaling) from the same iterate on the
mixed PSD + LP problem of tests/test_precision.py:76-96 (seed 5), JAX under
EXACT_MODES (tests/torch_cases.py) in both packages, so both run the same
algorithm. The JAX side runs in a fresh subprocess,
eagerly (op by op: no large XLA program, whose compile has aborted XLA:CPU
late in a long suite process, tests/test_precision.py:21-27), and writes an
.npz. The start is JAX's f64 iterate after 4 iterations (after 12 for the
dd NT scaling's step, where it departs from the f64 scaling); for dd2 it
gets seeded tails of relative size ~1e-17, so that every tail path carries
data. Held like test_torch_lp.py's steps: every stat within 1e-10 relative
(1e-13 absolute for the errors at their floor), the new iterate's dd values
within 1e-10 of its scale; the dd NT scaling's step also within
`NT_DD_TOL` (1e-15) of its scale, which the f64 scaling's step from the
same start misses on every field.

(b) The port's own CPU solves, at the JAX slow tests' sizes and floors. The
three that take under a minute are tier 1 (the LP synthetic and tru3 forced
sparse, both dd2, and the m = 8 dd2 solve under nt_precision='dd'); the
theta1 solves (30-90 s each on the CPU) are marked slow.

(c) Under -m slow: whole JAX solves of theta1 at 'dd' and 'dd2' beside the
port's, JAX under the port's modes (PALLAS_MODES).
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import loraine_tpu_torch as ltt
import loraine_tpu_torch.ipm.step as tstep
from loraine_tpu_torch.ipm.state import IPMState
from torch_cases import DD2_NT, EXACT_MODES, PALLAS_MODES, STEP_FIELDS, dd_nt_case

DATA = pathlib.Path(__file__).parent / "data"
REPO = pathlib.Path(__file__).resolve().parents[1]
THETA1 = str(DATA / "theta1.dat-s")


def _lp_data():
    """tests/test_precision.py:76-87: one 5x5 block, n = 6, 4 LP variables."""
    rng = np.random.default_rng(5)
    n, m = 6, 5
    A = rng.standard_normal((n, m, m))
    A = (A + A.transpose(0, 2, 1)) / 2
    C = np.eye(m)
    b = rng.standard_normal(n) * 0.1
    C_lin = rng.standard_normal((n, 4))
    d_lin = np.abs(rng.standard_normal(4)) + 1.0
    return [A], [C], b, C_lin, d_lin


# the JAX side of (a): f64 solve to iteration 4, then one eager dd step, one
# eager dd2 step and one eager dd2 step with the dd NT scaling from it (dd2
# with seeded tails)
_JAX_STEPS = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
import loraine_tpu as lt
from loraine_tpu.ipm.step import build_step
sys.path.insert(0, sys.argv[2])
from test_torch_precision import START, _lp_data, _step_opts, _tails
from torch_cases import EXACT_MODES, STEP_FIELDS
p = lt.problem_from_dense(*_lp_data(), storage="dense")
out = {}
for prec in ("dd", "dd2", "dd2nt"):
    mid = lt.solve(p, dict(EXACT_MODES, eDIMACS=1e-14, verb=0, maxit=START[prec])).final_state
    start = {"X": np.asarray(mid.X[0]), "S": np.asarray(mid.S[0]), "y": np.asarray(mid.y),
             "X_lin": np.asarray(mid.X_lin), "S_lin": np.asarray(mid.S_lin),
             "sigma": np.asarray(mid.sigma)}
    out.update({f"{prec}.start.{k}": v for k, v in start.items()})
    st = mid
    if prec != "dd":
        tails = _tails(start)
        st = dataclasses.replace(mid, X_lo=(jnp.asarray(tails["X_lo"]),),
                                 S_lo=(jnp.asarray(tails["S_lo"]),),
                                 **{k: jnp.asarray(tails[k]) for k in ("y_lo", "X_lin_lo", "S_lin_lo")})
    o = lt.Options.from_dict(_step_opts(prec)).validated()
    new, stats = build_step(o, -1)(p, st, 1e-3)
    for k in STEP_FIELDS:
        out[f"{prec}.stats.{k}"] = np.asarray(getattr(stats, k))
    for k in ("X", "S", "X_lo", "S_lo"):
        if getattr(new, k) is not None:
            out[f"{prec}.{k}"] = np.asarray(getattr(new, k)[0])
    for k in ("y", "X_lin", "S_lin", "y_lo", "X_lin_lo", "S_lin_lo"):
        if getattr(new, k) is not None:
            out[f"{prec}.{k}"] = np.asarray(getattr(new, k))
np.savez(sys.argv[1], **out)
"""

# the JAX f64 iterations before each step of (a): the dd NT scaling's step
# starts late (mu ~4e-11), where it departs from the f64 scaling's
START = {"dd": 4, "dd2": 4, "dd2nt": 12}
# (a)'s dd2nt step: the new iterate's dd values within this much of its
# scale (measured: 4.3e-17, on X_lin; the f64 NT scaling's step from the
# same start is 6.5e-15 to 1.1e-10 away, on every field)
NT_DD_TOL = 1e-15


def _step_opts(prec: str) -> dict:
    """The options of (a)'s step ``prec``: 'dd', 'dd2', or 'dd2nt' (dd2 with
    nt_precision='dd')."""
    extra = {"nt_precision": "dd"} if prec == "dd2nt" else {}
    return dict(EXACT_MODES, precision=prec[:3], **extra)


def _tails(st: dict) -> dict:
    """Seeded dd tails ~1e-17 relative to each start field (symmetric for
    the matrices)."""
    r = np.random.default_rng(55)
    out = {}
    for k in ("X", "S", "y", "X_lin", "S_lin"):
        t = st[k] * 1e-17 * r.standard_normal(st[k].shape)
        out[f"{k}_lo"] = (t + t.transpose(0, 2, 1)) / 2 if t.ndim == 3 else t
    return out


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dd_steps") / "steps.npz"
    tests = str(pathlib.Path(__file__).parent)
    subprocess.run([sys.executable, "-c", _JAX_STEPS, str(path), tests], check=True, cwd=REPO,
                   timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return dict(np.load(path))


def _start_state(j, prec):
    """(a)'s start for ``prec`` on the port, from the JAX run's values."""
    t = {k: torch.from_numpy(j[f"{prec}.start.{k}"])
         for k in ("X", "S", "y", "X_lin", "S_lin", "sigma")}
    st = IPMState(X=(t["X"],), S=(t["S"],), y=t["y"], X_lin=t["X_lin"], S_lin=t["S_lin"],
                  sigma=t["sigma"])
    if prec == "dd":
        return st
    tl = {k: torch.from_numpy(v) for k, v in _tails({k: v.numpy() for k, v in t.items()}).items()}
    return IPMState(X=st.X, S=st.S, y=st.y, X_lin=st.X_lin, S_lin=st.S_lin, sigma=st.sigma,
                    X_lo=(tl["X_lo"],), S_lo=(tl["S_lo"],), y_lo=tl["y_lo"],
                    X_lin_lo=tl["X_lin_lo"], S_lin_lo=tl["S_lin_lo"])


def _dd_gaps(new, j, prec):
    """field -> max |(hi - hi_j) + (lo - lo_j)| / max |hi_j| of the new
    iterate against the JAX step ``prec``'s."""
    out = {}
    for k in ("X", "S", "y", "X_lin", "S_lin"):
        hi, lo = getattr(new, k), getattr(new, f"{k}_lo")
        hi, lo = (hi[0], lo[0]) if isinstance(hi, tuple) else (hi, lo)
        ref, ref_lo = j[f"{prec}.{k}"], j[f"{prec}.{k}_lo"]
        out[k] = float(np.abs((hi.numpy() - ref) + (lo.numpy() - ref_lo)).max()
                       / np.abs(ref).max())
    return out


@pytest.mark.parametrize("prec", ["dd", "dd2", "dd2nt"])
def test_one_step_from_jax_state_matches(jax_steps, prec):
    j = jax_steps
    p = ltt.problem_from_dense(*_lp_data(), storage="dense", device="cpu")
    st = _start_state(j, prec)
    o = ltt.Options.from_dict(_step_opts(prec)).validated().resolved(p, p.device)
    new, stats = tstep.step(p, st, o, 1e-3)
    for name in STEP_FIELDS:
        a, b = float(getattr(stats, name)), float(j[f"{prec}.stats.{name}"])
        assert abs(a - b) <= 1e-10 * abs(b) + 1e-13, (name, a, b)
    fields = [("X", new.X[0]), ("S", new.S[0]), ("y", new.y), ("X_lin", new.X_lin),
              ("S_lin", new.S_lin)]
    for k, hi in fields:
        ref = j[f"{prec}.{k}"]
        if prec != "dd":
            lo, ref_lo = getattr(new, f"{k}_lo"), j[f"{prec}.{k}_lo"]
            lo = lo[0] if isinstance(lo, tuple) else lo
            # the dd value (hi - hi_j) + (lo - lo_j); well-formed tails
            diff = (hi.numpy() - ref) + (lo.numpy() - ref_lo)
            assert np.all(np.abs(lo.numpy()) <= 2.0**-52 * np.abs(hi.numpy()) + 1e-300), k
            assert np.abs(lo.numpy()).max() > 0 and np.abs(ref_lo).max() > 0, k
        else:
            assert getattr(new, "X_lo") is None
            diff = hi.numpy() - ref
        assert np.abs(diff).max() <= 1e-10 * np.abs(ref).max(), k
    if prec == "dd2nt":
        # the dd NT scaling's step to dd-class agreement, and the control:
        # the f64 scaling's step from the same start is farther on every field
        gaps = _dd_gaps(new, j, prec)
        assert max(gaps.values()) <= NT_DD_TOL, gaps
        o64 = ltt.Options.from_dict(_step_opts("dd2")).validated().resolved(p, p.device)
        gaps64 = _dd_gaps(tstep.step(p, st, o64, 1e-3)[0], j, prec)
        assert min(gaps64.values()) > NT_DD_TOL, gaps64


# ---- (b) the port's own CPU solves


def test_lp_synthetic_dd2_floor():
    """tests/test_precision.py:172-192: dd2 with the LP cone below 1e-13
    (measured on the CPU: 16 iterations, DIMACS 1.4e-14)."""
    p = ltt.problem_from_dense(*_lp_data(), storage="dense", device="cpu")
    r64 = ltt.solve(p, {"eDIMACS": 1e-7, "verb": 0}, device="cpu")
    r = ltt.solve(p, {"eDIMACS": 1e-13, "verb": 0, "precision": "dd2", "maxit": 40}, device="cpu")
    assert r64.status == 1 and r.status == 1
    assert abs(r64.objective - r.objective) < 1e-6
    assert r.dimacs < 1e-13
    assert r.final_state.X_lin_lo is not None and r.X_lin.shape == (4,)


def test_tru3_sparse_dd2_floor():
    """tests/test_precision.py:150-169: tru3 forced sparse at dd2 reaches
    the dd-class residual floors (measured on the CPU: 14 iterations, err1
    1.4e-24, err3 5.4e-33)."""
    p = ltt.problem_from_sdpa(str(DATA / "tru3.dat-s"), storage="sparse", device="cpu")
    assert any(g.is_sparse for g in p.groups)
    r = ltt.solve(p, {"kit": 0, "eDIMACS": 1e-9, "initpoint": 1, "verb": 0, "precision": "dd2"},
                  device="cpu")
    assert r.status == 1, r.status_name
    assert abs(r.objective - 0.0625018) < 1e-5
    assert r.errs["err1"] < 1e-18 and r.errs["err3"] < 1e-18


def test_dd_nt_e2e():
    """tests/test_precision.py::test_dd_nt_e2e_cpu: a whole dd2 solve under
    nt_precision='dd' (m = 8, n = 10, seed 5) with that test's gates
    (measured on the CPU: 15 iterations, DIMACS 7.9e-13, err1 1.6e-22,
    ~30 s). The gates do not tell the two NT scalings apart on this
    problem: under nt_precision='f64' the solve also ends OPTIMAL in 15
    iterations at DIMACS 7.93e-13, err1 2.4e-22 (the JAX package: 7.92e-13,
    1.3e-22). The step test's 'dd2nt' case is what separates them."""
    r = ltt.solve(dd_nt_case("cpu"), DD2_NT, device="cpu")
    assert r.status == 1, r.status_name
    assert r.dimacs < 1e-12
    assert r.errs["err1"] < 1e-18


@pytest.mark.slow
def test_theta1_dd_beyond_f64_floor():
    """tests/test_precision.py:36-48 (measured on the CPU: 16 iterations,
    DIMACS 1.2e-12, objective 23 + 7.5e-12, ~36 s)."""
    r = ltt.solve_sdpa(THETA1, {"kit": 0, "eDIMACS": 1e-11, "initpoint": 1, "verb": 0,
                                "precision": "dd", "maxit": 30}, device="cpu")
    assert r.status == 1 and r.dimacs < 1e-11
    assert abs(r.objective - 23.0) < 1e-9
    assert abs(r.objective - r.dual_objective) < 1e-9


@pytest.mark.slow
def test_theta1_dd2_iterate_tails():
    """tests/test_precision.py:99-115, with err1 < 1e-18 and err3 < 1e-15."""
    r = ltt.solve_sdpa(THETA1, {"kit": 0, "eDIMACS": 5e-13, "initpoint": 1, "verb": 0,
                                "precision": "dd2", "maxit": 30, "datasparsity": 0},
                       device="cpu")
    assert r.status == 1 and r.dimacs < 5e-13
    assert abs(r.objective - 23.0) < 1e-9
    assert r.errs["err1"] < 1e-18 and r.errs["err3"] < 1e-15


@pytest.mark.slow
@pytest.mark.parametrize("prec,tol,extra", [("dd", 1e-9, {}), ("dd2", 1e-10, {"datasparsity": 0})])
def test_theta1_cg_path(prec, tol, extra):
    """tests/test_precision.py:63-73 and 195-207: kit=1 under dd (DIMACS <
    1e-9) and dd2 (< 1e-10); measured on the CPU 14 and 15 iterations."""
    r = ltt.solve_sdpa(THETA1, dict({"precision": prec, "kit": 1, "preconditioner": 1,
                                     "eDIMACS": tol, "tol_cg_min": tol, "initpoint": 1,
                                     "verb": 0, "maxit": 40}, **extra), device="cpu")
    assert r.status == 1 and r.dimacs < tol and r.cg_iterations > 0
    np.testing.assert_allclose(r.objective, 23.0, rtol=1e-8)


# ---- (c) whole JAX solves beside the port's


@pytest.mark.slow
@pytest.mark.parametrize("prec,extra", [("dd", {}), ("dd2", {"datasparsity": 0})])
def test_theta1_solve_matches_jax(prec, extra):
    import loraine_tpu as lt

    opts = dict({"kit": 0, "eDIMACS": 1e-11, "initpoint": 1, "verb": 0, "precision": prec,
                 "maxit": 30}, **extra)
    rj = lt.solve_sdpa(THETA1, dict(opts, **PALLAS_MODES))
    rt = ltt.solve_sdpa(THETA1, opts, device="cpu")
    assert rt.status == rj.status == 1
    assert abs(rt.objective - rj.objective) < 1e-9
    assert abs(rt.iterations - rj.iterations) <= 2
    print(json.dumps({"prec": prec, "jax": [rj.iterations, rj.objective, rj.dimacs],
                      "port": [rt.iterations, rt.objective, rt.dimacs]}))
