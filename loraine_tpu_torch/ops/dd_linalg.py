"""Double-double dense linear algebra: scalar ops, GEMM, Cholesky and the
Jacobi eigensolver. Port of `loraine_tpu/ops/dd_linalg.py` (`dd_mul`,
`dd_sqr`, `dd_const`, `dd_div`, `dd_sqrt`, `dd_abs`, `dd_transpose`,
`dd_sym`, `dd_matmul`, `dd_chol`, `dd_eigh_jacobi`).

dd scalars are (hi, lo) f64 pairs (`ops/dd.py`); everything is branch-free
and batched. The native dd NT scaling (`ops/nt_scaling.py:nt_scale_dd`) is
the user of the matrix functions; the IPM step uses the scalar ops only.

On the TPU each matrix function is one XLA program. Here each has a
hand-written CUDA kernel (`csrc/dd_linalg.cu`, built with nvcc for sm_90a
at first use) and, beside it, its plain PyTorch version in the kernel's
order of operations, so that the two agree bit for bit on the card:

  D1 `dd_jacobi_cuda` / `dd_jacobi_plain`: the sweeps of `dd_eigh_jacobi`
  D2 `dd_chol_cuda` / `dd_chol_plain`: `dd_chol`
  D3 `dd_matmul_cuda` / `dd_matmul_plain`: `dd_matmul`

`dd_chol`, `dd_matmul` and `dd_eigh_jacobi` take the plain version for a
tensor on the CPU and launch the kernel for a CUDA tensor, with no
fallback; any other device raises. Each kernel wrapper counts its launches
(``.launches``; D1 and D2 also ``.launches_by_regime``, the regimes the
kernel library picks from m and the card: `plan_for`).

`dd_matmul` computes every term in dd (dd_mul, summed by dd_add in
ascending k); the JAX package's is the Ozaki-sliced GEMM stack, whose
products are exact and whose sum is truncated at 2^-106 of the |A||B|
scale, so the two agree to that scale. The Jacobi rotations are applied
elementwise, (A J)[i,j] = c_j A[i,j] + s_j A[i,perm j], then J^T (A J),
and V <- V J; the JAX package applies them as GEMMs with the full rotation
matrix J, a form it takes because XLA:CPU's fusion broke the error-free
transforms of the elementwise form (`loraine_tpu/ops/dd_linalg.py:283-300`).
Eager torch and the kernel round every operation once, so the elementwise
form keeps them exact. `dd_chol` is the JAX package's bit for bit.

The fold-blockers (``0.0 * x`` in `_dealias`, `dd_const`, `dd_sqrt`) work
around the XLA:CPU simplifier in the JAX package; eager torch has none, so
they are harmless here and keep the results bitwise the JAX package's.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .dd import DD, dd_add, dd_mul_f64, dd_neg, dd_sum, two_prod, two_sum
from .eigh import _default_sweeps, round_robin_pairs

__all__ = [
    "dd_mul",
    "dd_sqr",
    "dd_const",
    "dd_div",
    "dd_sqrt",
    "dd_abs",
    "dd_transpose",
    "dd_sym",
    "dd_matmul",
    "dd_matmul_plain",
    "dd_matmul_cuda",
    "dd_chol",
    "dd_chol_plain",
    "dd_chol_cuda",
    "dd_eigh_jacobi",
    "dd_jacobi_plain",
    "dd_jacobi_cuda",
    "plan_for",
    "regime_for",
]


def _renorm(hi: torch.Tensor, lo: torch.Tensor) -> DD:
    s = hi + lo
    t = (s - hi) + 0.0 * lo
    return DD(s, lo - t)


def dd_mul(x: DD, y: DD) -> DD:
    """Full dd * dd (error ~2^-104 relative)."""
    p = two_prod(x.hi, y.hi)
    t = x.hi * y.lo + x.lo * y.hi
    return _renorm(p.hi, p.lo + t)


def _dealias(x: DD) -> DD:
    """A value-identical copy (`dd_linalg.py:75-84`)."""
    return DD(x.hi + 0.0 * x.lo, x.lo + 0.0 * x.hi)


def dd_sqr(x: DD) -> DD:
    """dd square (`dd_mul(x, _dealias(x))`, as in the JAX package)."""
    return dd_mul(x, _dealias(x))


def dd_const(c: float, like: torch.Tensor) -> DD:
    """The dd constant c shaped like ``like``."""
    z = 0.0 * like
    return DD(z + c, z)


def _where(cond, a, b):
    """torch.where with Python-number branches taking the tensor's dtype."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.where(cond, a, b)


def dd_div(x: DD, y: DD) -> DD:
    """dd / dd via three corrected f64 quotients. ``y.hi`` must be nonzero
    (callers sanitize)."""
    yh = _where(y.hi != 0.0, y.hi, 1.0)
    q1 = x.hi / yh
    r = dd_add(x, dd_neg(dd_mul_f64(y, q1)))
    q2 = r.hi / yh
    r2 = dd_add(r, dd_neg(dd_mul_f64(y, q2)))
    q3 = r2.hi / yh
    q = two_sum(q1, q2)
    return _renorm(q.hi, q.lo + q3)


def dd_sqrt(x: DD) -> DD:
    """sqrt of a nonnegative dd (one dd-corrected Newton step); x.hi <= 0
    maps to exactly 0."""
    pos = x.hi > 0.0
    xh = _where(pos, x.hi, 1.0)
    s = torch.sqrt(xh)
    s2 = two_prod(s, s + 0.0 * s)
    r = dd_add(DD(xh, _where(pos, x.lo, 0.0)), DD(-s2.hi, -s2.lo))
    d = r.hi / (2.0 * s)
    out = two_sum(s, d)
    return DD(_where(pos, out.hi, 0.0), _where(pos, out.lo, 0.0))


def dd_abs(x: DD) -> DD:
    neg = x.hi < 0.0
    return DD(torch.where(neg, -x.hi, x.hi), torch.where(neg, -x.lo, x.lo))


def dd_transpose(x: DD) -> DD:
    return DD(x.hi.mT, x.lo.mT)


def dd_sym(x: DD) -> DD:
    s = dd_add(x, dd_transpose(x))
    return DD(0.5 * s.hi, 0.5 * s.lo)  # exact halving



# ---------------------------------------------------------------------------
# Jacobi rotation
# ---------------------------------------------------------------------------


def _rotation(app: DD, aqq: DD, apq: DD) -> Tuple[DD, DD]:
    """dd Givens rotation (c, s) zeroing the (p, q) entries, batched over
    [nb, m]. Pairs with |apq| below 2^-100 sqrt(|app aqq|) (the
    Demmel-Veselic relative criterion) get the identity rotation."""
    scale = torch.sqrt(torch.abs(app.hi * aqq.hi)) + 1e-300
    active = torch.abs(apq.hi) > 2.0**-100 * scale
    apq_s = DD(_where(active, apq.hi, 1.0), _where(active, apq.lo, 0.0))

    num = dd_add(aqq, dd_neg(app))
    den = dd_mul_f64(apq_s, torch.full_like(app.hi, 2.0))
    tau = dd_div(num, den)
    # past |tau| ~ 1e150 use the asymptotic t = 1/(2 tau)
    big = torch.abs(tau.hi) > 1e150
    tau_c = DD(_where(big, 1.0, tau.hi), _where(big, 0.0, tau.lo))
    sgn = torch.where(tau.hi >= 0.0, 1.0, -1.0).to(tau.hi.dtype)
    tau2 = dd_sqr(tau_c)
    one = dd_const(1.0, tau.hi)
    root = dd_sqrt(dd_add(one, tau2))
    den_t = dd_add(dd_abs(tau_c), root)
    t_small = dd_div(one, den_t)
    t_small = DD(sgn * t_small.hi, sgn * t_small.lo)
    t_big = dd_div(one, dd_mul_f64(tau, torch.full_like(tau.hi, 2.0)))
    t = DD(torch.where(big, t_big.hi, t_small.hi), torch.where(big, t_big.lo, t_small.lo))
    t = DD(_where(active, t.hi, 0.0), _where(active, t.lo, 0.0))

    c = dd_div(one, dd_sqrt(dd_add(one, dd_sqr(t))))
    s = dd_mul(t, c)
    return c, s


# ---------------------------------------------------------------------------
# the kernels (csrc/dd_linalg.cu) and their routes
# ---------------------------------------------------------------------------

# the regime codes of lt_dd_plan, per kernel
REGIMES = {"jacobi": ("global", "block", "cluster"), "chol": ("global", "warp")}
_KERNEL_CODES = {"jacobi": 0, "chol": 1}


@functools.lru_cache(maxsize=None)
def plan_for(kernel: str, m: int, force: int = 0, device_index: int = 0) -> Tuple[str, int, int]:
    """(regime, CTAs a matrix, scratch bytes a matrix) of D1 ("jacobi") or
    D2 ("chol") at m on the card, as the kernel library plans it
    (`lt_dd_plan`). D1: "block" (one block) to m 20, "cluster" (the matrix
    spread over a thread-block cluster's shared memory) to m 264 on an
    H100, "global" past it; D2: "warp" (L in one block's shared memory) to
    m 105, "global" past it. ``force`` (D1 only, a comparison):
    k > 0 a cluster of k CTAs in shared memory, k < 0 "global" with -k."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        code = _lib().lt_dd_plan(_KERNEL_CODES[kernel], m, force, out)
    if code < 0:
        raise ValueError(f"dd_{kernel}: m = {m} (force {force}) does not fit the kernel")
    return REGIMES[kernel][code], int(out[0]), 16 * int(out[1])


def regime_for(kernel: str, m: int, device_index: int = 0) -> str:
    """The regime that D1 ("jacobi") or D2 ("chol") takes at m on the card
    (`plan_for`)."""
    return plan_for(kernel, m, 0, device_index)[0]


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("dd_linalg")
    if not getattr(lib, "_lt_bound", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.lt_dd_plan.argtypes = [I, I, I, P]
        lib.lt_dd_jacobi.argtypes = [P] * 5 + [I] * 4 + [P]
        lib.lt_dd_chol.argtypes = [P] * 6 + [I] * 2 + [P]
        lib.lt_dd_gemm.argtypes = [P] * 6 + [I] * 4 + [P]
        for fn in (lib.lt_dd_plan, lib.lt_dd_jacobi, lib.lt_dd_chol, lib.lt_dd_gemm):
            fn.restype = I
        lib._lt_bound = True
    return lib


def _scratch(nbytes: int, device: torch.device) -> Optional[torch.Tensor]:
    """A kernel's global scratch (16-byte aligned), or None."""
    if not nbytes:
        return None
    return torch.empty((nbytes // 8,), dtype=torch.float64, device=device)


def _check(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.float64 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float64 CUDA tensors, got "
                             f"{t.dtype} on {t.device} (contiguous {t.is_contiguous()})")


def _launch(fn, device: torch.device, *args) -> None:
    """Call a C entry on ``device``'s current stream; raises on its code."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc == -2:
        raise ValueError(f"{fn.__name__}: the shape does not fit the kernel")
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {rc}")


def _route(x: torch.Tensor, plain, cuda, *args):
    if x.device.type == "cpu":
        return plain(*args)
    if x.device.type == "cuda":
        return cuda(*args)
    raise ValueError(f"no dd linear-algebra route for device {x.device}")


# ---- D3: the dd GEMM -------------------------------------------------------


def dd_matmul_plain(A: DD, B: DD) -> DD:
    """D3's plain version: C[..., i, j] = sum over k of dd_mul(A[i,k],
    B[k,j]), the first term, then dd_add of each next one in ascending k;
    batch dims broadcast as `torch.matmul`."""
    k = A.hi.shape[-1]
    if B.hi.shape[-2] != k or k < 1:
        raise ValueError(f"contraction mismatch {tuple(A.hi.shape)} @ {tuple(B.hi.shape)}")

    def term(kk):
        return dd_mul(DD(A.hi[..., :, kk : kk + 1], A.lo[..., :, kk : kk + 1]),
                      DD(B.hi[..., kk : kk + 1, :], B.lo[..., kk : kk + 1, :]))

    acc = term(0)
    for kk in range(1, k):
        acc = dd_add(acc, term(kk))
    return acc


def dd_matmul_cuda(A: DD, B: DD) -> DD:
    """D3 on the card: same contract as `dd_matmul_plain` (one launch)."""
    (m, k), (k2, n) = A.hi.shape[-2:], B.hi.shape[-2:]
    if k2 != k or k < 1:
        raise ValueError(f"contraction mismatch {tuple(A.hi.shape)} @ {tuple(B.hi.shape)}")
    batch = torch.broadcast_shapes(A.hi.shape[:-2], B.hi.shape[:-2])

    def flat(x, r, c):
        return x.expand(*batch, r, c).reshape(-1, r, c).contiguous()

    a = [flat(x, m, k) for x in A]
    b = [flat(x, k, n) for x in B]
    nb = a[0].shape[0]
    ch = torch.empty((nb, m, n), dtype=torch.float64, device=a[0].device)
    cl = torch.empty_like(ch)
    _check("dd_matmul_cuda", *a, *b)
    if nb:
        _launch(_lib().lt_dd_gemm, ch.device, *(t.data_ptr() for t in (*a, *b, ch, cl)),
                nb, m, k, n)
        dd_matmul_cuda.launches += 1
    return DD(ch.reshape(*batch, m, n), cl.reshape(*batch, m, n))


def dd_matmul(A: DD, B: DD) -> DD:
    """(A.hi + A.lo) @ (B.hi + B.lo) in dd: D3 on a CUDA tensor, its plain
    version on a CPU one."""
    return _route(A.hi, dd_matmul_plain, dd_matmul_cuda, A, B)


# ---- D2: the dd Cholesky ---------------------------------------------------


def dd_chol_plain(A: DD) -> Tuple[DD, torch.Tensor]:
    """D2's plain version: the batched dd Cholesky of SPD [nb, m, m] dd
    matrices, (L, ok) with A = L L^T to ~2^-104 relative, ``ok`` [nb] False
    where a pivot was nonpositive at dd resolution (L is garbage there).

    Left-looking: at step j, t[i] = sum_k L[i,k] L[j,k] is a dd dot over all
    m columns (the uncomputed ones are exactly zero), in `dd_sum`'s tree."""
    nb, m, _ = A.hi.shape
    Lh = torch.zeros_like(A.hi)
    Ll = torch.zeros_like(A.hi)
    ok = torch.ones((nb,), dtype=torch.bool, device=A.hi.device)
    rows = torch.arange(m, device=A.hi.device)
    for j in range(m):
        rj = DD(Lh[:, j : j + 1, :], Ll[:, j : j + 1, :])  # [nb, 1, m]
        t = dd_sum(dd_mul(DD(Lh, Ll), rj), axis=-1)  # [nb, m]
        c = dd_add(DD(A.hi[..., j], A.lo[..., j]), dd_neg(t))
        dh, dl = c.hi[:, j : j + 1], c.lo[:, j : j + 1]  # pivot [nb, 1]
        pos = dh > 0.0
        ok = ok & pos[:, 0]
        piv = dd_sqrt(DD(_where(pos, dh, 1.0), _where(pos, dl, 0.0)))
        col = dd_div(c, DD(piv.hi.expand_as(c.hi), piv.lo.expand_as(c.lo)))
        below = (rows > j)[None, :]
        at_j = (rows == j)[None, :]
        Lh[..., j] = _where(below, col.hi, 0.0) + _where(at_j, piv.hi.expand_as(c.hi), 0.0)
        Ll[..., j] = _where(below, col.lo, 0.0) + _where(at_j, piv.lo.expand_as(c.lo), 0.0)
    return DD(Lh, Ll), ok


def dd_chol_cuda(A: DD) -> Tuple[DD, torch.Tensor]:
    """D2 on the card: same contract as `dd_chol_plain` (one launch)."""
    nb, m, _ = A.hi.shape
    ah, al = A.hi.contiguous(), A.lo.contiguous()
    _check("dd_chol_cuda", ah, al)
    regime, _, scratch = plan_for("chol", m, 0, ah.device.index)
    lh, ll = torch.empty_like(ah), torch.empty_like(ah)
    ok = torch.empty((nb,), dtype=torch.bool, device=ah.device)
    if nb:
        S = _scratch(nb * scratch, ah.device)
        _launch(_lib().lt_dd_chol, ah.device, ah.data_ptr(), al.data_ptr(), lh.data_ptr(),
                ll.data_ptr(), None if S is None else S.data_ptr(), ok.data_ptr(), nb, m)
        dd_chol_cuda.launches += 1
        dd_chol_cuda.launches_by_regime[regime] += 1
    return DD(lh, ll), ok


def dd_chol(A: DD) -> Tuple[DD, torch.Tensor]:
    """Batched dd Cholesky of SPD [nb, m, m] dd matrices (`dd_chol_plain`'s
    contract): D2 on a CUDA tensor, its plain version on a CPU one."""
    return _route(A.hi, dd_chol_plain, dd_chol_cuda, A)


# ---- D1: the dd Jacobi sweeps ----------------------------------------------


@functools.lru_cache(maxsize=None)
def _jacobi_rounds(m: int):
    """Per round of `round_robin_pairs(m)`: p = min and q = max of each pair
    [R, m/2], every index's partner [R, m] and its position in cat(p, q)
    [R, m] (int64 numpy, read-only)."""
    pairs = round_robin_pairs(m).astype(np.int64)
    p, q = pairs.min(axis=1), pairs.max(axis=1)
    nrounds, h = p.shape
    partner = np.empty((nrounds, m), dtype=np.int64)
    pos = np.empty((nrounds, m), dtype=np.int64)
    for r in range(nrounds):
        partner[r, p[r]], partner[r, q[r]] = q[r], p[r]
        pos[r, p[r]], pos[r, q[r]] = np.arange(h), np.arange(h, 2 * h)
    for a in (p, q, partner, pos):
        a.flags.writeable = False
    return p, q, partner, pos


def dd_jacobi_plain(B: DD, V: DD, sweeps: int) -> Tuple[DD, DD]:
    """D1's plain version: ``sweeps`` sweeps of the round-robin parallel
    cyclic Jacobi on symmetric dd [nb, m, m] (m even) from the basis V.
    Each round: (c, s) per pair from p = min, q = max (`_rotation`), c on
    both indices, s_p = -s, s_q = +s; (A J)[i,j] = c_j A[i,j] +
    s_j A[i,perm j] and V J; then (J^T B)[i,j] = c_i B[i,j] + s_i
    B[perm i,j]; each entry dd_add(dd_mul(c, .), dd_mul(s, .)). `dd_sym`
    after each sweep. Returns (A, V), unsorted."""
    nb, m, _ = B.hi.shape
    dev = B.hi.device
    p_t, q_t, part_t, pos_t = (torch.tensor(t, device=dev) for t in _jacobi_rounds(m))
    A, V = B, V
    for _ in range(sweeps):
        for r in range(m - 1):
            p, q, part, pos = p_t[r], q_t[r], part_t[r], pos_t[r]
            c, s = _rotation(DD(A.hi[:, p, p], A.lo[:, p, p]), DD(A.hi[:, q, q], A.lo[:, q, q]),
                             DD(A.hi[:, p, q], A.lo[:, p, q]))  # [nb, m/2]
            cj = DD(torch.cat([c.hi, c.hi], 1)[:, pos], torch.cat([c.lo, c.lo], 1)[:, pos])
            sj = DD(torch.cat([-s.hi, s.hi], 1)[:, pos], torch.cat([-s.lo, s.lo], 1)[:, pos])
            ccol = DD(cj.hi[:, None, :], cj.lo[:, None, :])
            scol = DD(sj.hi[:, None, :], sj.lo[:, None, :])
            A = dd_add(dd_mul(ccol, A), dd_mul(scol, DD(A.hi[:, :, part], A.lo[:, :, part])))
            V = dd_add(dd_mul(ccol, V), dd_mul(scol, DD(V.hi[:, :, part], V.lo[:, :, part])))
            crow = DD(cj.hi[:, :, None], cj.lo[:, :, None])
            srow = DD(sj.hi[:, :, None], sj.lo[:, :, None])
            A = dd_add(dd_mul(crow, A), dd_mul(srow, DD(A.hi[:, part, :], A.lo[:, part, :])))
        A = dd_sym(A)
    return A, V


def _jacobi_run(B: DD, V: DD, sweeps: int, force: int = 0) -> Tuple[Tuple[DD, DD], str]:
    """One launch of D1 (``force`` as `plan_for`'s), uncounted: ((A, V),
    the regime)."""
    nb, m, _ = B.hi.shape
    if m % 2 or m < 2 or V.hi.shape != B.hi.shape or sweeps < 0:
        raise ValueError(f"dd_jacobi_cuda: B {tuple(B.hi.shape)}, V {tuple(V.hi.shape)}, "
                         f"sweeps {sweeps}: needs even m >= 2 and V shaped as B")
    # the kernel rotates these copies in place
    out = [x.clone(memory_format=torch.contiguous_format) for x in (*B, *V)]
    _check("dd_jacobi_cuda", *out)
    regime, _, scratch = plan_for("jacobi", m, force, out[0].device.index)
    if nb:
        S = _scratch(nb * scratch, out[0].device)
        _launch(_lib().lt_dd_jacobi, out[0].device, *(t.data_ptr() for t in out),
                None if S is None else S.data_ptr(), nb, m, sweeps, force)
    return (DD(out[0], out[1]), DD(out[2], out[3])), regime


def dd_jacobi_cuda(B: DD, V: DD, sweeps: int) -> Tuple[DD, DD]:
    """D1 on the card: same contract as `dd_jacobi_plain` (one launch)."""
    out, regime = _jacobi_run(B, V, sweeps)
    if B.hi.shape[0]:
        dd_jacobi_cuda.launches += 1
        dd_jacobi_cuda.launches_by_regime[regime] += 1
    return out


for _fn in (dd_matmul_cuda, dd_chol_cuda, dd_jacobi_cuda):
    _fn.launches = 0
for _fn in (dd_chol_cuda, dd_jacobi_cuda):
    _fn.launches_by_regime = collections.Counter()


def _diag(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1)


def dd_eigh_jacobi(
    M: DD,
    sweeps: Optional[int] = None,
    V0: Optional[torch.Tensor] = None,
) -> Tuple[DD, DD]:
    """Eigendecomposition of a batch of symmetric dd matrices [nb, m, m]:
    M = V diag(lam) V^T, eigenvalues ascending, all in dd.

    ``V0``: optional f64 eigenbasis warm start. It is first made orthogonal
    to ~u64^2 by one dd Newton-Schulz step, then B = V0^T M V0 in dd and the
    sweeps clean up the remaining off-diagonal mass. Defaults: 6 sweeps
    warm, the f64 solver's count + 2 cold. The sweeps are D1 on a CUDA
    tensor, `dd_jacobi_plain` on a CPU one."""
    nb, m, _ = M.hi.shape
    dt, dev = M.hi.dtype, M.hi.device
    if sweeps is None:
        sweeps = 6 if V0 is not None else _default_sweeps(m) + 2

    if V0 is not None:
        V0h = V0.to(dt)
        Vdd = DD(V0h, torch.zeros_like(V0h))
        VtV = dd_matmul(dd_transpose(Vdd), Vdd)
        # C = 1.5 I - 0.5 V'V in dd (the diagonal cancellation must be exact)
        eye15 = 1.5 * torch.eye(m, dtype=dt, device=dev).expand_as(VtV.hi)
        C = dd_add(DD(eye15, 0.0 * eye15), DD(-0.5 * VtV.hi, -0.5 * VtV.lo))
        Vdd = dd_matmul(Vdd, C)
        B = dd_sym(dd_matmul(dd_transpose(Vdd), dd_matmul(M, Vdd)))
        Vstart = Vdd
    else:
        eye = torch.eye(m, dtype=dt, device=dev).expand_as(M.hi)
        B = M
        Vstart = DD(eye, torch.zeros_like(eye))

    mm = m + (m % 2)
    if mm != m:
        # odd m: pad with a decoupled diagonal entry above the spectrum
        big = torch.abs(B.hi).sum(-1).max() + 1.0
        Bh = torch.zeros((nb, mm, mm), dtype=dt, device=dev)
        Bl = torch.zeros_like(Bh)
        Bh[:, :m, :m] = B.hi
        Bh[:, m, m] = big
        Bl[:, :m, :m] = B.lo
        Vh = torch.zeros_like(Bh)
        Vl = torch.zeros_like(Bh)
        Vh[:, :m, :m] = Vstart.hi
        Vh[:, m, m] = 1.0
        Vl[:, :m, :m] = Vstart.lo
        B, Vstart = DD(Bh, Bl), DD(Vh, Vl)
    A, V = _route(B.hi, dd_jacobi_plain, dd_jacobi_cuda, B, Vstart, sweeps)

    lam = DD(_diag(A.hi), _diag(A.lo))
    order = torch.argsort(lam.hi, dim=-1, stable=True)
    lam = DD(torch.gather(lam.hi, -1, order), torch.gather(lam.lo, -1, order))
    vo = order[:, None, :].expand(nb, mm, mm)
    V = DD(torch.gather(V.hi, -1, vo), torch.gather(V.lo, -1, vo))
    if mm != m:
        return DD(lam.hi[:, :m], lam.lo[:, :m]), DD(V.hi[:, :m, :m], V.lo[:, :m, :m])
    return lam, V
