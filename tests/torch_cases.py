"""Shared inputs of the tests/test_torch_*.py files (not a test module)."""
import types

import numpy as np
import pytest

from loraine_tpu_torch.io.sdpa import SDPAData


def maxcut_sdpa(N: int = 40, seed: int = 40, cls=SDPAData):
    """Seeded random max-cut in SDPA form, built like
    `loraine_tpu.models.maxcut.maxcut_problem` (F_0 = L/4, F_j = -E_jj)."""
    rng = np.random.default_rng(seed)
    W = np.triu(rng.random((N, N)) < 0.3, 1) * rng.integers(1, 10, (N, N))
    W = (W + W.T).astype(float)
    deg = W @ np.ones(N)
    rows0, cols0 = np.nonzero(np.triu(W, 1))
    mat = np.concatenate([np.zeros(N + rows0.size, dtype=np.int64), np.arange(1, N + 1)])
    row = np.concatenate([np.arange(N), rows0, np.arange(N)])
    col = np.concatenate([np.arange(N), cols0, np.arange(N)])
    val = np.concatenate([0.25 * (deg - np.diag(W)), -0.25 * W[rows0, cols0], -np.ones(N)])
    return cls(nvar=N, block_sizes=[N], c=-np.ones(N), blocks=[(mat, row, col, val)])


def spectrum_matrix(kind: str, m: int, nb: int, seed: int) -> np.ndarray:
    """The spectra of tests/test_jacobi_pallas.py: random symmetric,
    IPM-like clustered (half at 1.0, a graded tail) and graded."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        A = rng.standard_normal((nb, m, m))
        return (A + A.transpose(0, 2, 1)) / 2
    if kind == "clustered":
        d = np.concatenate(
            [np.full((nb, m // 2), 1.0), 10.0 ** rng.uniform(-6, 0, (nb, m - m // 2))],
            axis=1,
        )
    else:  # graded
        d = 10.0 ** rng.uniform(-8, 2, (nb, m))
    Q = np.linalg.qr(rng.standard_normal((nb, m, m)))[0]
    A = Q @ (d[:, :, None] * np.eye(m)) @ Q.transpose(0, 2, 1)
    return (A + A.transpose(0, 2, 1)) / 2


def sized_problem(n: int, nlin: int = 0, rank1: bool = False):
    """What `Options.resolved` reads of a problem (n, nlin, each group's
    is_rank1), without its data: one group."""
    return types.SimpleNamespace(n=n, nlin=nlin, groups=(types.SimpleNamespace(is_rank1=rank1),))


# the native dd NT scaling end to end (tests/test_precision.py::test_dd_nt_e2e_cpu)
DD2_NT = {"kit": 0, "eDIMACS": 1e-12, "verb": 0, "precision": "dd2", "nt_precision": "dd",
          "maxit": 40}


def dd_nt_case(device="cuda"):
    """The problem of tests/test_precision.py::test_dd_nt_e2e_cpu: one dense
    8x8 block, n = 10, seed 5 (the native dd NT scaling's end-to-end case)."""
    import loraine_tpu_torch as ltt

    rng = np.random.default_rng(5)
    m, n = 8, 10
    A = rng.standard_normal((n, m, m))
    A = (A + A.transpose(0, 2, 1)) / 2
    C = rng.standard_normal((m, m))
    C = C @ C.T + m * np.eye(m)
    return ltt.problem_from_dense([A], [C], np.einsum("jpp->j", A), storage="dense",
                                  device=device)


# Eigen/step modes under which the two packages run the same algorithm
# (ROADMAP "Held against the reference"). PALLAS_MODES is the path the port
# takes: the Jacobi kernels (Pallas in interpret mode on the JAX side, the
# plain PyTorch versions on the port's CPU side), whose f32 seeds differ at
# f32 rounding and reach the trajectory through the steplength bounds at
# ~1e-5 relative. EXACT_MODES takes the library's f64 eigh for the NT
# scaling and exact f64 eigenvalues for the steplengths in both packages,
# so that a test can hold the rest of the step's f64 arithmetic to
# rounding.
PALLAS_MODES = {"eigh_backend": "pallas", "step_eig": "pallas", "cg_kernel": "xla"}
EXACT_MODES = {"eigh_backend": "xla", "step_eig": "exact", "cg_kernel": "xla"}
STEP_FIELDS = ("obj", "mu", "sigma", "err1", "err2", "err3", "err4", "err5", "err6",
               "dimacs", "alpha_min", "beta_min", "h_shifts", "h_ok", "nt_ok",
               "cg_iter_pre", "cg_iter_cor")


def step_both(pj, state_j, opts, tol_cg=1e-3, modes=EXACT_MODES, mixed_assembly=False):
    """One step of each package from the same JAX iterate, both under
    ``modes`` (EXACT_MODES by default) and with the same ``mixed_assembly``.
    Returns ((new_j, stats_j), (new_t, stats_t))."""
    import jax

    import loraine_tpu as lt
    import loraine_tpu_torch as ltt
    from loraine_tpu.ipm.step import build_step
    from loraine_tpu_torch.convert import problem_from_numpy, state_from_numpy
    from loraine_tpu_torch.ipm.step import step

    precond = opts.get("preconditioner", 1) if opts.get("kit", 0) == 1 else -1
    oj = lt.Options.from_dict(dict(opts, **modes)).validated()
    new_j, stats_j = jax.jit(build_step(oj, precond, mixed_assembly=mixed_assembly))(
        pj, state_j, tol_cg)
    pt = problem_from_numpy(jax.device_get(pj), device="cpu")
    st = state_from_numpy(jax.device_get(state_j), device="cpu")
    ot = ltt.Options.from_dict(dict(opts, **modes)).validated().resolved(pt, pt.device)
    new_t, stats_t = step(pt, st, ot, tol_cg, precond if precond >= 0 else None, mixed_assembly)
    return (new_j, stats_j), (new_t, stats_t)


def solve_pair(path, opts, modes):
    """(JAX result, port result) of one whole `solve_sdpa` on the CPU, both
    packages under ``modes``."""
    import loraine_tpu as lt
    import loraine_tpu_torch as ltt

    return (lt.solve_sdpa(path, dict(opts, **modes)),
            ltt.solve_sdpa(path, dict(opts, **modes), device="cpu"))


def errs_agree(rj, rt, rtol, atol=1e-13):
    """err1..err6 of two solves' histories per iteration while JAX's DIMACS
    > 1e-4; ``atol`` covers errors at their floor (err1 ~ 4e-15 on tru3
    with kit=0)."""
    k = sum(1 for h in rj.history if h["dimacs"] > 1e-4)
    assert k >= 8
    for hj, ht in zip(rj.history[:k], rt.history[:k]):
        for e in ("err1", "err2", "err3", "err4", "err5", "err6"):
            assert abs(ht[e] - hj[e]) <= rtol * abs(hj[e]) + atol, (e, ht[e], hj[e])


def assert_same_step(j, t, rtol=1e-10, atol=1e-13):
    """Every StepStats field and the new iterate (X, S, y, X_lin, S_lin)
    within rtol (atol for the errors at their rounding floor)."""
    (new_j, stats_j), (new_t, stats_t) = j, t
    for name in STEP_FIELDS:
        a, b = float(getattr(stats_t, name)), float(np.asarray(getattr(stats_j, name)))
        assert abs(a - b) <= rtol * abs(b) + atol, (name, a, b)
    pairs = list(zip(new_t.X + new_t.S, new_j.X + new_j.S))
    pairs.append((new_t.y, new_j.y))
    if new_j.X_lin is not None:
        pairs += [(new_t.X_lin, new_j.X_lin), (new_t.S_lin, new_j.S_lin)]
    else:
        assert new_t.X_lin is None and new_t.S_lin is None
    for a, b in pairs:
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= rtol * np.abs(b).max()


def assert_same_problem(pt, pj):
    """Every array of the port's problem ``pt`` equal to the JAX package's
    ``pj`` (carried over by `convert.problem_from_numpy`)."""
    import jax

    from loraine_tpu_torch.convert import problem_from_numpy

    ref = problem_from_numpy(jax.device_get(pj), device="cpu")
    assert (pt.n, pt.nlin, pt.nlmi, pt.b_const, pt.sum_msizes) == \
        (ref.n, ref.nlin, ref.nlmi, ref.b_const, ref.sum_msizes)
    for name in ("b", "C_lin", "d_lin"):
        a, r = getattr(pt, name), getattr(ref, name)
        assert (a is None) == (r is None), name
        assert a is None or np.array_equal(a.numpy(), r.numpy()), name
    assert len(pt.groups) == len(ref.groups)
    for g, gr in zip(pt.groups, ref.groups):
        assert (g.m, g.nb, g.orig_sizes, g.orig_indices) == (gr.m, gr.nb, gr.orig_sizes,
                                                             gr.orig_indices)
        np.testing.assert_allclose(g.data_norms, gr.data_norms, rtol=1e-15)
        np.testing.assert_allclose(g.C_norms, gr.C_norms, rtol=1e-15)
        for name in ("C", "A", "B", "Bsgn", "Arows", "Acols", "Avals"):
            a, r = getattr(g, name), getattr(gr, name)
            assert (a is None) == (r is None), name
            assert a is None or np.array_equal(a.numpy(), r.numpy()), name


def jax_cpu_modes(problem) -> dict:
    """The eigen and step modes the JAX package's CPU 'auto' resolves to for
    ``problem`` (`loraine_tpu/ops/eigh.py:eigh_backend_for`,
    `ipm/step.py:_bound_fns`): the eager f64 Jacobi below m = 192, the
    library f32 seed with f64 refinement from there; exact eigenvalues for
    the steplengths."""
    m = max((g.m for g in problem.groups), default=0)
    return {"eigh_backend": "jacobi" if m < 192 else "mixed", "step_eig": "exact"}


class _PortOnCPU:
    """The JAX package's API as its test suites call it (`problem_from_dense`,
    `problem_from_sdpa`, `solve`, `solve_sdpa`), served by the port on the
    CPU under the JAX CPU run's modes (`jax_cpu_modes`; an option the
    caller sets wins). With it a port suite keeps the JAX suite's cases and
    assertions word for word."""

    @staticmethod
    def problem_from_dense(*args, **kwargs):
        import loraine_tpu_torch as ltt

        return ltt.problem_from_dense(*args, device="cpu", **kwargs)

    @staticmethod
    def problem_from_sdpa(*args, **kwargs):
        import loraine_tpu_torch as ltt

        return ltt.problem_from_sdpa(*args, device="cpu", **kwargs)

    @staticmethod
    def solve(problem, options=None):
        import loraine_tpu_torch as ltt

        return ltt.solve(problem, {**jax_cpu_modes(problem), **(options or {})}, device="cpu")

    @classmethod
    def solve_sdpa(cls, path, options=None):
        import loraine_tpu_torch as ltt

        return cls.solve(ltt.load_problem(path, options, device="cpu"), options)


PORT_CPU = _PortOnCPU()


@pytest.fixture(scope="module")
def one_torch_thread():
    """Torch on one thread for a module: its eager loops are 10^4-10^5 tiny
    ops, and with several test workers on one machine torch's intra-op
    pool turns each into a contended barrier (a conformance case: ~1 s on
    one thread, 90-140 s on eight beside five busy workers)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
