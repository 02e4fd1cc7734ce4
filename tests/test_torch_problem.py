"""loraine_tpu_torch problem building against loraine_tpu.load_problem.

The port must stack, pad and factor exactly as the JAX package does: the
same groups, padded shapes, block order, host norms and arrays, bit for bit
(both build the arrays with the same numpy code in f64).
"""
import pathlib

import numpy as np
import pytest
import torch

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from loraine_tpu.io.sdpa import SDPAData as JaxSDPAData
from loraine_tpu.problem import problem_from_sdpa as jax_problem_from_sdpa
from loraine_tpu_torch.ipm.initial import initial_point
from loraine_tpu_torch.problem import problem_from_sdpa
from torch_cases import maxcut_sdpa

DATA = pathlib.Path(__file__).parent / "data"


def assert_same_problem(pt, pj):
    assert (pt.n, pt.nlin, pt.nlmi, pt.sum_msizes, pt.b_const) == (
        pj.n, pj.nlin, pj.nlmi, pj.sum_msizes, pj.b_const)
    np.testing.assert_array_equal(pt.b.numpy(), np.asarray(pj.b))
    assert len(pt.groups) == len(pj.groups)
    for gt, gj in zip(pt.groups, pj.groups):
        assert (gt.m, gt.nb, gt.orig_sizes, gt.orig_indices) == (
            gj.m, gj.nb, gj.orig_sizes, gj.orig_indices)
        assert gt.data_norms == gj.data_norms and gt.C_norms == gj.C_norms
        assert gt.is_rank1 == gj.is_rank1
        assert gt.is_sparse == gj.is_sparse
        for name in ("C", "A", "B", "Bsgn", "Arows", "Acols", "Avals"):
            a, b = getattr(gt, name), getattr(gj, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == (torch.int64 if name in ("Arows", "Acols") else torch.float64)
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for name in ("C_lin", "d_lin"):
        a, b = getattr(pt, name), getattr(pj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("name,opts", [
    ("theta1.dat-s", {}),
    ("control1.dat-s", {}),
    ("maxG11.dat-s", {"datarank": -1}),
])
def test_load_problem_matches_jax(name, opts):
    pj = lt.load_problem(str(DATA / name), opts)
    pt = ltt.load_problem(str(DATA / name), opts, device="cpu")
    assert_same_problem(pt, pj)
    assert pt.groups[0].is_rank1 == (opts.get("datarank") == -1)


def test_maxcut_rank1_matches_jax():
    pj = jax_problem_from_sdpa(maxcut_sdpa(cls=JaxSDPAData), datarank=-1)
    pt = problem_from_sdpa(maxcut_sdpa(), datarank=-1, device="cpu")
    assert pt.groups[0].is_rank1
    assert_same_problem(pt, pj)


def test_rank1_falls_back_to_dense_like_jax():
    # theta1's A_j are rank 2: the 5e-6 guard rejects the factorization
    with pytest.warns(UserWarning, match="falling back"):
        pt = ltt.load_problem(str(DATA / "theta1.dat-s"), {"datarank": -1}, device="cpu")
    with pytest.warns(UserWarning, match="falling back"):
        pj = lt.load_problem(str(DATA / "theta1.dat-s"), {"datarank": -1})
    assert not pt.groups[0].is_rank1
    assert_same_problem(pt, pj)


@pytest.mark.parametrize("name,opts", [
    ("theta1.dat-s", {"initpoint": 1}),
    ("control1.dat-s", {"initpoint": 0}),
    ("maxG11.dat-s", {"initpoint": 1, "datarank": -1}),
])
def test_initial_point_matches_jax(name, opts):
    from loraine_tpu.ipm.initial import initial_point as jax_initial_point

    pj = lt.load_problem(str(DATA / name), opts)
    pt = ltt.load_problem(str(DATA / name), opts, device="cpu")
    sj = jax_initial_point(pj, lt.Options.from_dict(opts).validated())
    st = initial_point(pt, ltt.Options.from_dict(opts).validated())
    # same numpy formulas on the same host norms: 1e-15 relative
    for a, b in zip(st.X + st.S, sj.X + sj.S):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=0)
    np.testing.assert_array_equal(st.y.numpy(), np.asarray(sj.y))
    assert float(st.sigma) == float(sj.sigma)


def test_unported_storage_raises():
    """The LP cone (tru3) and sparse storage once raised NotImplementedError;
    both now load exactly as the JAX package loads them."""
    for name, opts in (("tru3", {}), ("control1", {"datasparsity": 1000})):
        pj = lt.load_problem(str(DATA / f"{name}.dat-s"), opts)
        pt = ltt.load_problem(str(DATA / f"{name}.dat-s"), opts, device="cpu")
        assert_same_problem(pt, pj)
    assert pt.groups[0].is_sparse and pt.groups[0].adj is not None  # control1
