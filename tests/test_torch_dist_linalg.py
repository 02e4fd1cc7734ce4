"""The row-distributed blocked Cholesky, tri_inv and cho_solve_inv of
loraine_tpu_torch (`ops/linalg.py`, ``mesh=``) on (1, 2) and (1, 4) meshes
of Gloo CPU ranks: the rows of H split over the 'schur' axis, n = 160 and
300 (two and three panels of 128, panels that straddle two ranks). Held
against torch.linalg.cholesky / inv / solve and against the JAX package's
`chol_blocked` and `tri_inv` (unsharded, same panel width) to 1e-12
relative; on an indefinite matrix, the NaN pattern of the failing panel
and the `chol_reg` shift count against both packages' single-device
versions. The ranks run tests/torch_mesh_worker.py in subprocesses."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from loraine_tpu.ops import linalg as jlinalg
from loraine_tpu_torch.ops.linalg import chol_reg
from loraine_tpu_torch.parallel.distributed import launch
from torch_mesh_worker import _spd, indefinite

WORKER = __file__.replace("test_torch_dist_linalg.py", "torch_mesh_worker.py")
RTOL = 1e-12
_RUNS = {}


def _run(nproc, tmp_path_factory):
    """Every rank's results of the 'linalg' case, rows assembled."""
    if nproc not in _RUNS:
        out = tmp_path_factory.mktemp(f"linalg{nproc}")
        launch([WORKER, "linalg", "--out", str(out)], nproc, timeout=300)
        ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(nproc)]
        # the row-sharded factors (keys L*) stacked in rank order
        _RUNS[nproc] = {k: np.concatenate([r[k] for r in ranks]) if k.startswith("L")
                        else ranks[0][k] for k in ranks[0]} | {"ranks": ranks}
    return _RUNS[nproc]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("nproc", [2, 4])
@pytest.mark.parametrize("n", [160, 300])
def test_chol_blocked_matches(nproc, n, tmp_path_factory):
    R = _run(nproc, tmp_path_factory)
    M = _spd(n, n)
    assert [bool(r[f"rows{n}"][2]) for r in R["ranks"]] == [True] * nproc  # rows split
    L = R[f"L{n}"]
    assert L.shape == (n, n)
    assert _rel(L, torch.linalg.cholesky(torch.tensor(M)).numpy()) <= RTOL
    assert _rel(L, np.asarray(jlinalg.chol_blocked(jnp.asarray(M), base=128))) <= RTOL


@pytest.mark.parametrize("nproc", [2, 4])
@pytest.mark.parametrize("n", [160, 300])
def test_tri_inv_matches(nproc, n, tmp_path_factory):
    R = _run(nproc, tmp_path_factory)
    L = np.linalg.cholesky(_spd(n, n))
    Li = R[f"Li{n}"]
    assert _rel(Li, torch.linalg.inv(torch.tensor(L)).numpy()) <= RTOL
    assert _rel(Li, np.asarray(jlinalg.tri_inv(jnp.asarray(L), base=128))) <= RTOL


@pytest.mark.parametrize("nproc", [2, 4])
@pytest.mark.parametrize("n", [160, 300])
def test_cho_solve_inv_matches(nproc, n, tmp_path_factory):
    R = _run(nproc, tmp_path_factory)
    b = np.random.default_rng(n + 1).standard_normal(n)
    x = np.linalg.solve(_spd(n, n), b)
    for r in R["ranks"]:  # replicated: every rank holds the whole solution
        assert _rel(r[f"x{n}"], x) <= RTOL


@pytest.mark.parametrize("nproc", [2, 4])
def test_nan_pattern_matches_jax(nproc, tmp_path_factory):
    """An indefinite pivot in the second panel: NaN from that panel's
    diagonal block onward (on and below the diagonal), exactly where the
    JAX chol_blocked puts it."""
    R = _run(nproc, tmp_path_factory)
    Ljax = np.asarray(jlinalg.chol_blocked(jnp.asarray(indefinite(300, 5)), base=128))
    np.testing.assert_array_equal(np.isnan(R["Lnan"]), np.isnan(Ljax))
    assert np.isnan(R["Lnan"][128:, 128:]).any() and not np.isnan(R["Lnan"][:128]).any()


@pytest.mark.parametrize("nproc", [2, 4])
def test_chol_reg_shift_count_matches(nproc, tmp_path_factory):
    R = _run(nproc, tmp_path_factory)
    M = indefinite(300, 5)
    ref = chol_reg(torch.tensor(M), 1e-4, 1000)
    jref = jlinalg.chol_reg(jnp.asarray(M), 1e-4, 1000)
    for r in R["ranks"]:  # the retry decision is all-reduced: same count everywhere
        assert int(r["reg"][0]) == ref.shifts == int(jref.shifts) == 3
        assert bool(r["reg"][1]) and ref.ok
    assert _rel(R["Lreg"], ref.L.numpy()) <= RTOL
