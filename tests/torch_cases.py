"""Shared inputs of the tests/test_torch_*.py files (not a test module)."""
import numpy as np

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
