"""Checkpoints (`utils/checkpoint.py`) of loraine_tpu_torch against the JAX
package, on the CPU.

- The .npz layout is the JAX package's, key for key and array for array,
  for f64 and dd2 states with and without the LP cone; and, as in the JAX
  package, `load_state` reads a dd2 checkpoint's X_lo, S_lo and y_lo but
  not its LP tails (ROADMAP Queue C).
- A checkpoint written by one package resumes in the other: under
  EXACT_MODES both resumes reach the same status and iteration count,
  objectives within 1e-8 relative.
- tests/test_checkpoint.py's own cases on the port: resume under the port's
  'auto' (B1 and B2's plain versions here), and the dd2 tail reconciliation.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from loraine_tpu_torch.convert import state_from_numpy
from torch_cases import EXACT_MODES, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DATA = pathlib.Path(__file__).parent / "data"
OPTS = {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0}


def _jax_state(seed, ngroups, nlin, dd2):
    """A JAX IPMState of seeded arrays (dd2 tails, the LP tails too, when
    ``dd2``)."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return jnp.asarray(rng.standard_normal(shape))

    blocks = lambda: tuple(a(2, 8, 8) for _ in range(ngroups))  # noqa: E731
    lin = (a(nlin), a(nlin)) if nlin else (None, None)
    tails = {}
    if dd2:
        tails = dict(X_lo=blocks(), S_lo=blocks(), y_lo=a(5))
        if nlin:
            tails.update(X_lin_lo=a(nlin), S_lin_lo=a(nlin))
    return lt.IPMState(X=blocks(), S=blocks(), y=a(5), X_lin=lin[0], S_lin=lin[1],
                       sigma=jnp.asarray(3.0), **tails)


@pytest.mark.parametrize("ngroups,nlin,dd2", [(1, 0, False), (2, 3, False), (1, 0, True),
                                              (2, 3, True)])
def test_npz_layout_key_for_key(tmp_path, ngroups, nlin, dd2):
    sj = _jax_state(ngroups + nlin, ngroups, nlin, dd2)
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    lt.save_state(pj, sj)
    ltt.save_state(pt, state_from_numpy(sj, device="cpu"))
    zj, zt = np.load(pj), np.load(pt)
    assert sorted(zt.files) == sorted(zj.files)
    for k in zj.files:
        assert zt[k].dtype == zj[k].dtype and np.array_equal(zt[k], zj[k]), k
    # the port reads the JAX file as the JAX package reads it
    rj, rt = lt.load_state(pj), ltt.load_state(pj, device="cpu")
    for name in ("X", "S", "X_lo", "S_lo"):
        a, b = getattr(rt, name), getattr(rj, name)
        assert (a is None) == (b is None)
        assert a is None or all(np.array_equal(x.numpy(), np.asarray(y)) for x, y in zip(a, b))
    for name in ("y", "X_lin", "S_lin", "sigma", "y_lo", "X_lin_lo", "S_lin_lo"):
        a, b = getattr(rt, name), getattr(rj, name)
        assert (a is None) == (b is None), name
        assert a is None or np.array_equal(a.numpy(), np.asarray(b)), name
    # neither package reads the LP tails back
    assert rt.X_lin_lo is None and rt.S_lin_lo is None


@pytest.mark.parametrize("path,writer", [("theta1", "jax"), ("theta1", "port"),
                                         ("tru3", "jax"), ("tru3", "port")])
def test_checkpoint_crosses_packages(tmp_path, path, writer):
    """A checkpoint of a 4-iteration solve written by ``writer`` resumes in
    both packages to the same result."""
    sdpa = str(DATA / f"{path}.dat-s")
    opts = dict(OPTS, **EXACT_MODES)
    pj = lt.problem_from_sdpa(sdpa)
    pt = ltt.problem_from_sdpa(sdpa, device="cpu")
    ck = str(tmp_path / "ckpt.npz")
    if writer == "jax":
        part = lt.solve(pj, {**opts, "maxit": 4})
        lt.save_state(ck, part.final_state)
    else:
        part = ltt.solve(pt, {**opts, "maxit": 4}, device="cpu")
        ltt.save_state(ck, part.final_state)
    assert part.status == 4
    rj = lt.Solver(pj, lt.Options.from_dict(opts), initial_state=lt.load_state(ck)).solve()
    rt = ltt.Solver(pt, opts, initial_state=ltt.load_state(ck, device="cpu"),
                    device="cpu").solve()
    assert rt.status == rj.status == 1
    assert rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= 1e-8 * abs(rj.objective)


def test_checkpoint_resume_port_auto(tmp_path):
    """tests/test_checkpoint.py::test_checkpoint_resume on the port."""
    full = ltt.solve_sdpa(str(DATA / "theta1.dat-s"), dict(OPTS), device="cpu")
    prob = ltt.problem_from_sdpa(str(DATA / "theta1.dat-s"), device="cpu")
    part = ltt.solve(prob, {**OPTS, "maxit": 4}, device="cpu")
    assert part.status == 4
    path = str(tmp_path / "ckpt.npz")
    ltt.save_state(path, part.final_state)
    state = ltt.load_state(path, device="cpu")
    resumed = ltt.Solver(prob, ltt.Options.from_dict(OPTS), initial_state=state,
                         device="cpu").solve()
    assert resumed.status == 1
    np.testing.assert_allclose(resumed.objective, full.objective, rtol=1e-6)
    assert part.iterations + resumed.iterations <= full.iterations + 3


def test_pre_dd2_checkpoint_tail_zero_fill(tmp_path):
    """tests/test_checkpoint.py's tail reconciliation on the port: an f64
    checkpoint resumed under 'dd2' gets zero tails, a dd2 state resumed at
    f64 drops them."""
    prob = ltt.problem_from_sdpa(str(DATA / "theta1.dat-s"), device="cpu")
    part = ltt.solve(prob, {**OPTS, "maxit": 3}, device="cpu")
    path = str(tmp_path / "ckpt_f64.npz")
    ltt.save_state(path, part.final_state)
    state = ltt.load_state(path, device="cpu")
    assert state.X_lo is None
    s = ltt.Solver(prob, {"kit": 0, "verb": 0, "precision": "dd2", "datasparsity": 0},
                   initial_state=state, device="cpu")
    norm = s._normalize_tails(state)
    assert norm.X_lo is not None and norm.S_lo is not None
    assert all(float(t.abs().max()) == 0.0 for t in norm.X_lo)
    assert float(norm.y_lo.abs().max()) == 0.0
    s64 = ltt.Solver(prob, {"kit": 0, "verb": 0}, device="cpu")
    assert s64._normalize_tails(norm).X_lo is None
