"""The eigen and assembly modes of loraine_tpu_torch against the JAX package,
on the CPU: `eigh_jacobi`, `eigh_mixed(seed='xla32')`, `eigmin_lanczos`
(`ops/eigh.py`), `eigmin_chol` (`ops/linalg.py`), `nt_scale` under every
``eigh_backend`` and ``method='svd'`` (`ops/nt_scaling.py`) and the f32
Schur assembly (`ops/schur.py:schur_group_mixed`, `schur_lp_mixed`).

None of these reaches a Pallas kernel in the JAX package, so both sides run
plain XLA / torch code on the same seeded numpy inputs. Tolerances (``nrm``
is the spectral norm, ``nrm_inf`` the largest absolute row sum):

- `eigh_jacobi`: eigenvalues within 1e-12 nrm of JAX's, residual
  ||M V - V Lambda|| <= 1e-12 nrm and orthogonality <= 1e-13;
- `eigh_mixed`: tests/test_eigh.py's bounds on its spectra, and eigenvalues
  within 1e-10 nrm of JAX's where the f32 seed resolves the spectrum. On the
  graded spectrum (eigenvalues down to 1e-12 nrm, below f32's resolution of
  the shifted matrix) the two packages' f32 `eigh` (two LAPACK builds) give
  different seeds, and the refined eigenvalues at the bottom differ by
  ~5e-8 nrm; there both are held to the file's bound 5e-7;
- `eigmin_lanczos` within 1e-10 nrm of JAX's and never above the true
  lambda_min on tests/test_eigmin_lanczos.py's matrices; `eigmin_chol`'s
  bracket within 2^-40 nrm_inf of JAX's and certified;
- `nt_scale` ('mixed', 'jacobi', 'xla', 'svd'): D, G, Gi, W, Si and DDsi
  within 1e-10 relative, G and Gi up to the sign of each eigenvector (the
  library `eigh` of the two packages may pick either), and
  tests/test_nt_scaling.py's identities;
- `schur_group_mixed`, `schur_lp_mixed`: within 1e-6 relative of JAX's (f32
  GEMMs in two BLAS builds) and 1e-5 of the port's f64 assembly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loraine_tpu as lt
from loraine_tpu.ops import eigh as jeigh, linalg as jlin, nt_scaling as jnt, schur as jschur
from loraine_tpu_torch.convert import problem_from_numpy
from loraine_tpu_torch.ops import eigh as teigh, linalg as tlin, nt_scaling as tnt, schur as tschur


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager Jacobi and Lanczos loops here are 10^4-10^5 tiny torch ops
    each. With several test workers on one machine, torch's intra-op thread
    pool turns every op into a contended barrier (a 3-iteration theta1
    solve under 'jacobi': 1.5 s on one thread, 185 s on eight beside five
    busy processes). One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64))


def sym_random(rng, nb, m):
    A = rng.standard_normal((nb, m, m))
    return (A + A.transpose(0, 2, 1)) / 2


def with_spectrum(lam, seed=0):
    """tests/test_eigh.py:_with_spectrum: Q diag(lam) Q^T, [1, m, m]."""
    m = lam.shape[0]
    Q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((m, m)))
    return (Q @ np.diag(lam) @ Q.T)[None]


def spd(rng, nb, m, lo=-1.0, hi=1.0):
    Q = np.linalg.qr(rng.standard_normal((nb, m, m)))[0]
    d = 10.0 ** rng.uniform(lo, hi, (nb, m))
    A = Q @ (d[:, :, None] * np.eye(m)) @ Q.transpose(0, 2, 1)
    return (A + A.transpose(0, 2, 1)) / 2


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("m", [6, 15, 50])
def test_eigh_jacobi_matches_jax(m):
    M = sym_random(np.random.default_rng(m), 3, m)
    nrm = np.abs(np.linalg.eigvalsh(M)).max()
    lj, _ = jeigh.eigh_jacobi(jnp.asarray(M))
    lam, V = teigh.eigh_jacobi(T(M))
    lam, V = lam.numpy(), V.numpy()
    assert np.abs(lam - np.asarray(lj)).max() <= 1e-12 * nrm
    assert np.abs(M @ V - V * lam[:, None, :]).max() <= 1e-12 * nrm
    assert np.abs(V.transpose(0, 2, 1) @ V - np.eye(m)).max() <= 1e-13
    assert np.all(np.diff(lam, axis=-1) >= 0)


def test_round_robin_pairs_and_sweeps_match_jax():
    for m in (2, 6, 16, 50):
        assert np.array_equal(teigh.round_robin_pairs(m), jeigh.round_robin_pairs(m))
    for m in (2, 6, 50, 128, 800, 5000):
        assert teigh._default_sweeps(m) == jeigh._default_sweeps(m)


MIXED_SPECTRA = [
    ("separated", np.linspace(0.5, 1.5, 96), 0),
    ("graded", np.logspace(-12, 0, 96), 0),
    ("cluster-at-mu", 1e-8 * (1 + 1e-7 * np.arange(96)), 0),
    ("f32-unresolvable", np.sort(1 + 1e-9 * np.arange(96)), 0),
    ("ipm-like", np.r_[np.full(48, 2.0), np.full(48, 2.02)] * np.linspace(1, 1.001, 96), 0),
    ("indefinite", np.linspace(-2.0, 3.0, 64), 5),
]


@pytest.mark.parametrize("name,lam,seed", MIXED_SPECTRA, ids=[s[0] for s in MIXED_SPECTRA])
def test_eigh_mixed_xla32_matches_jax(name, lam, seed):
    M = with_spectrum(np.asarray(lam, dtype=float), seed)
    lt_, V = teigh.eigh_mixed(T(M))
    lj, _ = jeigh.eigh_mixed(jnp.asarray(M))  # seed 'xla32' in both
    lt_, V = lt_.numpy(), V.numpy()
    ref = np.linalg.eigvalsh(M)
    nrm = max(abs(ref[0, 0]), abs(ref[0, -1]))
    lam_err = np.abs(lt_ - ref).max() / nrm
    rec_err = np.abs(V @ (lt_[..., None] * V.transpose(0, 2, 1)) - M).max() / nrm
    orth = np.abs(V.transpose(0, 2, 1) @ V - np.eye(M.shape[-1])).max()
    bound = 1e-10 if name == "indefinite" else 5e-7  # tests/test_eigh.py:66-80
    assert orth < 1e-12 and rec_err < bound and lam_err < bound
    diff = np.abs(lt_ - np.asarray(lj)).max() / nrm
    assert diff <= (5e-7 if name == "graded" else 1e-10), diff


def lanczos_cases():
    """The matrices of tests/test_eigmin_lanczos.py, drawn in that file's
    order from its module-level default_rng(11): four random symmetric
    batches, a graded m=400 spectrum, a PD batch. name -> (M, tight) with
    ``tight`` the file's slack bound on true - bound (None: the file checks
    positivity instead)."""
    rng = np.random.default_rng(11)
    out = {}
    for m, nb in [(17, 4), (31, 3), (56, 2), (120, 2)]:
        M = sym_random(rng, nb, m)
        out[f"random-{m}"] = (M, 1e-5 * np.abs(np.linalg.eigvalsh(M)[:, 0]) + 1e-6)
    m = 400
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    M = (Q * -np.logspace(-6, 0, m)) @ Q.T
    M = (M + M.T) / 2
    out["graded-400"] = (M[None], 1e-6 * np.abs(np.linalg.eigvalsh(M)[0]))
    A = rng.standard_normal((2, 64, 64))
    out["pd-64"] = (A @ A.transpose(0, 2, 1) + 0.1 * np.eye(64), None)
    return out


LANCZOS = ("random-17", "random-31", "random-56", "random-120", "graded-400", "pd-64")


@pytest.mark.parametrize("name", LANCZOS)
def test_eigmin_lanczos_matches_jax(name):
    """Within 1e-10 nrm of JAX's bound, never above the true lambda_min, and
    tight (or, on the PD batch, positive) as tests/test_eigmin_lanczos.py
    requires. The bound is certified on these matrices only: with 48 steps
    from a fixed start nothing guarantees it in general (`ops/eigh.py`)."""
    M, tight = lanczos_cases()[name]
    lo = teigh.eigmin_lanczos(T(M)).numpy()
    true = np.linalg.eigvalsh(M)
    nrm = np.abs(true).max()
    assert np.abs(lo - np.asarray(jeigh.eigmin_lanczos(jnp.asarray(M)))).max() <= 1e-10 * nrm
    slack = true[:, 0] - lo
    assert np.all(slack >= -1e-10)
    assert np.all(slack <= tight) if tight is not None else np.all(lo > 0)


@pytest.mark.parametrize("m,nb", [(12, 4), (50, 2)])
def test_eigmin_chol_matches_jax(m, nb):
    """The bisection bracket of JAX's `eigmin_chol` to 2^-40 ||M||_inf
    (its width after 45 halvings is 2^-44 ||M||_inf), certified and tight
    (tests/test_nt_scaling.py:49-60)."""
    M = sym_random(np.random.default_rng(5 + m), nb, m)
    lo = tlin.eigmin_chol(T(M)).numpy()
    nrm_inf = np.abs(M).sum(-1).max()
    assert np.abs(lo - np.asarray(jlin.eigmin_chol(jnp.asarray(M)))).max() <= 2.0**-40 * nrm_inf
    exact = tlin.eigmin(T(M)).numpy()
    np.testing.assert_allclose(exact, np.linalg.eigvalsh(M)[:, 0], rtol=1e-12, atol=1e-13)
    assert np.all(lo <= exact + 1e-12)
    np.testing.assert_allclose(lo, exact, rtol=1e-8, atol=1e-10)


# (eigh_backend 'pallas' against JAX: tests/test_torch_ops.py::test_nt_scale_matches_jax)
NT_CASES = [("eigh", b) for b in ("mixed", "jacobi", "xla")] + [("svd", "xla")]


@pytest.mark.parametrize("method,backend", NT_CASES, ids=[f"{m}-{b}" for m, b in NT_CASES])
@pytest.mark.parametrize("nb,m", [(2, 16), (3, 5)])
def test_nt_scale_modes_match_jax(method, backend, nb, m):
    rng = np.random.default_rng(100 + m)
    X, S = spd(rng, nb, m), spd(rng, nb, m)
    a = jnt.nt_scale(jnp.asarray(X), jnp.asarray(S), method=method, eigh_backend=backend)
    b = tnt.nt_scale(T(X), T(S), method=method, eigh_backend=backend)
    for k in ("D", "W", "Si", "DDsi"):
        assert rel(getattr(b, k).numpy(), getattr(a, k)) < 1e-10, k
    Gj, Gij = np.asarray(a.G), np.asarray(a.Gi)
    s = np.sign(np.sum(b.G.numpy() * Gj, axis=-2, keepdims=True))  # column signs
    assert rel(b.G.numpy() * s, Gj) < 1e-10
    assert rel(b.Gi.numpy() * s.transpose(0, 2, 1), Gij) < 1e-10
    assert bool(b.ok) and not b.shifted and not bool(b.s_indef)
    # tests/test_nt_scaling.py:19-37
    G, Gi, D = b.G.numpy(), b.Gi.numpy(), b.D.numpy()
    GT, eye = G.transpose(0, 2, 1), np.broadcast_to(np.eye(m), X.shape)
    np.testing.assert_allclose(G @ GT, b.W.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(GT @ S @ G, D[:, :, None] * eye, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(Gi @ X @ Gi.transpose(0, 2, 1), D[:, :, None] * eye,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(b.W.numpy() @ S @ b.W.numpy(), X, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(b.Si.numpy() @ S, eye, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(b.DDsi.numpy(), 1.0 / np.sqrt(D), rtol=1e-7)
    np.testing.assert_allclose(Gi @ G, eye, atol=1e-8)


@pytest.fixture(scope="module")
def mixed_groups():
    """tests/test_schur.py:126-187's dense (2 x 40 x 12 x 12), sparse and
    rank-1 groups and an LP block, in both packages, with one SPD W and
    G = chol(W)."""
    rng = np.random.default_rng(2)
    nb, n, m = 2, 40, 12
    A = rng.standard_normal((nb, n, m, m))
    A = A + A.transpose(0, 1, 3, 2)
    dense = lt.problem_from_dense(list(A), [np.eye(m) * m] * nb, np.zeros(n),
                                  storage="dense", pad_multiple=1)
    As = np.zeros((n, m, m))
    for j in range(n):
        r, c = rng.integers(0, m, 2)
        v = rng.standard_normal()
        As[j, r, c] += v
        if r != c:
            As[j, c, r] += v
        As[j, j % m, j % m] += 1.0
    sparse = lt.problem_from_dense([As], [np.eye(m) * m], np.zeros(n), storage="sparse",
                                   pad_multiple=1)
    V = rng.standard_normal((n, m))
    rank1 = lt.problem_from_dense([np.einsum("jp,jq->jpq", V, V)], [np.eye(m) * m],
                                  np.zeros(n), datarank=-1, pad_multiple=1)
    W = rng.standard_normal((nb, m, m))
    W = W @ W.transpose(0, 2, 1) + m * np.eye(m)
    C_lin = rng.standard_normal((n, 17))
    w = np.abs(rng.standard_normal(17)) + 0.1
    out = {}
    for name, pj in (("dense", dense), ("sparse", sparse), ("rank1", rank1)):
        gj = pj.groups[0]
        Wg = W[: gj.nb]
        out[name] = (gj, problem_from_numpy(jax.device_get(pj), device="cpu").groups[0], Wg,
                     np.linalg.cholesky(Wg))
    return out, C_lin, w


@pytest.mark.parametrize("kind", ["dense", "sparse", "rank1", "lp"])
def test_schur_mixed_matches_jax(mixed_groups, kind):
    groups, C_lin, w = mixed_groups
    if kind == "lp":
        Hj = jschur.schur_lp_mixed(jnp.asarray(C_lin), jnp.asarray(w))
        Ht = tschur.schur_lp_mixed(T(C_lin), T(w))
        H64 = tschur.schur_lp(T(C_lin), T(w))
    else:
        gj, gt, W, G = groups[kind]
        Hj = jschur.schur_group_mixed(gj, jnp.asarray(W), jnp.asarray(G))
        Ht = tschur.schur_group_mixed(gt, T(W), T(G))
        H64 = tschur.schur_group(gt, T(W), T(G))
    assert Ht.dtype == torch.float64
    assert rel(Ht.numpy(), Hj) < 1e-6
    # rank-1 and sparse groups stay exact f64, as in the JAX package
    assert rel(Ht.numpy(), H64.numpy()) < (1e-14 if kind in ("sparse", "rank1") else 1e-5)
