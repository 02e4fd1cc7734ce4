"""Solver options. Port of `loraine_tpu/config.py`.

Same names, defaults and validation/auto-correction as the JAX package (which
mirrors Loraine.jl `src/Solvers.jl:169-302`). Every value the JAX package
accepts is accepted and runs here too.

What the port runs: ``kit`` 0 and 1, ``precision`` 'f64', 'dd' and 'dd2'
(both paths, every storage, the LP cone), every value of ``dtype``,
``nt_method``, ``nt_precision``, ``eigh_backend``, ``step_eig``,
``assembly_precision``, ``cg_kernel``, ``cg_materialize``,
``chol_backend`` and ``gemm_backend``, ``timing`` (``timing >= 2`` prints
the per-phase table of `utils/diagnostics.py` after the solve) and
``profile_dir`` (a `torch.profiler` trace of the solve written into that
directory, CUDA activity included on a card, with the solve's phase spans:
`utils/timers.py:span`).

On a ('blocks', 'schur') mesh (`parallel/`: one process per rank,
`torch.distributed`; Gloo ranks on the CPU, ``python -m
loraine_tpu_torch.parallel.dryrun --nproc 4 --device cpu``; on cards NCCL,
one rank per card, or Gloo for ranks sharing one card) every option value
above runs, the precision tiers and ``nt_precision='dd'`` included (their
dd sums over a sharded axis through `Mesh.reduce_dd`).
On a mesh whose 'schur' axis splits H's rows the kit=0 Cholesky is the
distributed blocked one (`ops/linalg.py`), and the kit=1 materialized
route gathers Hcg whole on every rank and then follows ``cg_kernel`` as on
one device.

Every 'auto' is resolved once, in one place: `Options.resolved(problem,
device)` returns a copy with none left (the route the solve takes).
`Solver` resolves after its kit downgrades, `solve_admm` and
`utils/diagnostics.py:profile_phases` at their entries, and every caller
of `ipm/step.py:step` before it; `step` refuses an unresolved value
(`require_resolved`). ``Solver.opts``, the log header, the `Result` and
checkpoints keep the values the user gave.

In the port 'pallas' means the hand-written Jacobi kernels of
`ops/jacobi.py` (CUDA C++ in `csrc/jacobi.cu`), and 'auto' resolves to them
on every device; on a CPU tensor they run their plain PyTorch version, so
CPU and card runs take the same algorithmic path. The JAX package's 'auto'
is 'pallas' on the TPU only; its CPU runs are the port's explicit values
``eigh_backend='jacobi'`` (m < 192) or ``'mixed'`` (m >= 192) with
``step_eig='exact'``.

``eigh_backend`` (NT scaling, `ops/nt_scaling.py`; the exact steplengths):
'pallas' is B1's f32 seed refined to f64 (`ops/eigh.py:eigh_mixed`);
'mixed' the same refinement from the library's f32 `eigh` (cuSOLVER on the
card, LAPACK on the CPU); 'jacobi' the f64 Jacobi of `ops/eigh.py` as eager
tensor ops; 'xla' the library's f64 `eigh`. The preconditioner
(`ops/precond.py`) sends 'pallas' and 'xla' to the library's f64 `eigh`, as
the JAX package does.

``step_eig`` (`ipm/step.py:_bound_fns`): 'pallas' (= 'auto') is B2's
certified bound with the predictor identity; 'exact' the smallest
eigenvalue by ``eigh_backend`` (B2 under 'pallas'/'auto', `eigh_mixed`
with one refinement pass under 'mixed', 7 Jacobi sweeps under 'jacobi',
`eigvalsh` under 'xla'); 'chol' a 45-step Cholesky bisection; 'lanczos' the
48-step Lanczos bound, with a Cholesky PSD probe for err2/err4.

``nt_method``: 'eigh' factors X only; 'svd' factors X and S and takes the
library SVD (the reference's formulation).

``dtype='float32'``: the problem, the iterates and every step in f32 on
both paths (B1 and B2 take f32 inputs as they are; the kit=1 CG kernels
run on f64 copies of the f32 operator).

``assembly_precision``: 'f32' assembles the Schur matrix with f32 GEMMs
(`ops/schur.py:schur_group_mixed`, dense and LP data; rank-1 and sparse
groups stay exact) until DIMACS < 1e-3, then hands over to f64 for good;
'auto' does so on a CUDA device for n >= 512 with dense or LP data where H
is assembled, and never on the CPU (the JAX package's rule with the card in
the TPU's place); 'f64' never.

``nt_precision``: 'dd' (with precision 'dd2' only) is the native dd NT
scaling (`ops/nt_scaling.py:nt_scale_dd`: dd Cholesky, dd congruence, dd
Jacobi eigendecomposition from B1's warm start under 'pallas'/'auto'),
whose dd Cholesky, GEMM and Jacobi sweeps are the hand-written kernels
D2, D3 and D1 of `csrc/dd_linalg.cu` on the card (their plain PyTorch
versions on the CPU). 'auto' resolves as the JAX package's
(`loraine_tpu/ipm/step.py:364-370`) with the card in the TPU's place: the
dd NT scaling under 'dd2' when the problem lives on a CUDA device, the
f64 one on the CPU (so every CPU run keeps its trajectory); 'dd' and 'f64'
stand. One departure: on the CG path (kit=1) 'auto' is the f64 NT
scaling on the card too. There theta1 at 'dd2' under the dd scaling
breaks down at iteration 20 on the card, while the same solve ends
OPTIMAL with the CPU's dd scaling of the card's own iterates, and D1-D3
equal their plain versions bit for bit throughout: rounding-level
differences decide the kit=1 end game (ROADMAP Queue C 8;
`utils/cg_dd2_probe.py`). Under 'dd'/'dd2' the kit=1 path runs f64 `pcg` inside dd
refinement and takes no CG kernel, whatever ``cg_kernel`` says.

``gemm_backend``: 'f64' (the default) leaves every product to the library
(cuBLAS DGEMM on the card); 'int8' computes the rank-1 Schur products
(kit=0 and the kit=1 materialized route) by the integer Ozaki scheme
(`ops/int8gemm.py`: 76 exact int8 products per f64-accurate GEMM, in the
hand-written kernels O1/O2 of `csrc/int8gemm.cu` on the card's int8
tensor cores, their plain PyTorch version on the CPU); dense and sparse
groups ignore it. On the H100 it is expected to be slower than DGEMM
(PERF.md has both times), so it stays opt-in, as in the JAX package.

``chol_backend``: 'auto' (the default) resolves to 'f64' on every device,
as the JAX package's 'auto' does off
the TPU; 'f64' is the library's f64 Cholesky (cuSOLVER on the card);
'mixed' the f32-panel Cholesky with f64 Newton refinement and a per-panel
f64 fallback (`ops/mixed_chol.py`: library calls, no kernel, up to two
host syncs a 128-column panel), for the NT scaling's factor of X and the
kit=0 Schur factor. On a row-split mesh the Schur factor stays the
distributed f64 one, as in the JAX package.

``cg_kernel`` (materialized CG route only): 'ff' is the
single-launch f64 CG kernel B3 and 'pallas' the f32 CG kernel B4
(`ops/pcg.py`, CUDA C++ in `csrc/pcg.cu`); on a CPU tensor each runs its
plain PyTorch version. 'xla' is the eager f64 CG of `ops/cg.py`. 'auto' is
'ff' on a CUDA device for n <= 1024 and 'xla' otherwise, as the JAX package
picks 'ff' on the TPU and 'xla' on the CPU.

``cg_materialize`` (kit=1): 'always' assembles Hcg and takes the
materialized CG route, 'never' the matrix-free one; 'auto' is 'always' for
n <= 512 (`loraine_tpu/ipm/step.py:726`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional

import torch

# the options whose value 'auto' `Options.resolved` replaces
AUTO_FIELDS = ("step_eig", "eigh_backend", "chol_backend", "cg_kernel", "cg_materialize",
               "assembly_precision", "nt_precision")


@dataclasses.dataclass
class Options:
    """Options for the interior-point solver (reference semantics:
    Loraine.jl `docs/src/Loraine_options.md:4-56`; the meaning of each field
    is documented on `loraine_tpu.config.Options`)."""

    kit: int = 0
    tol_cg: float = 1.0e-2
    tol_cg_up: float = 0.5
    tol_cg_min: float = 1.0e-7
    eDIMACS: float = 1.0e-7
    preconditioner: int = 1
    erank: int = 1
    aamat: int = 1
    fig_ev: int = 0
    verb: int = 1
    datarank: int = 0
    initpoint: int = 0
    timing: int = 1
    maxit: int = 100
    datasparsity: Optional[int] = None
    dtype: str = "float64"
    pad_multiple: int = 8
    step_eig: str = "auto"
    cg_maxiter: int = 10000
    cg_materialize: str = "auto"
    cg_kernel: str = "auto"
    profile_dir: str = ""
    nt_method: str = "eigh"
    eigh_backend: str = "auto"
    gemm_backend: str = "f64"  # "int8": rank-1 Schur products by the O1/O2 kernels
    chol_backend: str = "auto"  # "auto" = "f64"; "mixed": f32 panels + f64 Newton
    precision: str = "f64"
    assembly_precision: str = "f64"
    nt_precision: str = "auto"

    def validated(self) -> "Options":
        """Range-check options, auto-correcting out-of-range values with a
        warning (reference `src/Solvers.jl:263-291`)."""
        o = dataclasses.replace(self)
        if o.kit < 0 or o.kit > 1:
            o.kit = 0
            _warn(f"Parameter kit out of range, setting kit = {o.kit}")
        if o.tol_cg < o.tol_cg_min and o.kit == 1:
            o.tol_cg = o.tol_cg_min
            _warn(f"Parameter tol_cg smaller than tol_cg_min, setting tol_cg = {o.tol_cg:.1e}")
        if o.tol_cg_min > o.eDIMACS and o.kit == 1:
            o.tol_cg_min = o.eDIMACS
            _warn(f"Parameter tol_cg_min switched to eDIMACS = {o.eDIMACS:.1e}")
        if o.kit == 1 and (o.preconditioner < 0 or o.preconditioner > 4):
            o.preconditioner = 1
            _warn(f"Parameter preconditioner out of range, setting preconditioner = {o.preconditioner}")
        if o.erank < 0:
            o.erank = 1
            _warn(f"Parameter erank negative, setting erank = {o.erank}")
        if o.datarank < -1:
            o.datarank = 0
            _warn(f"Parameter datarank out of range, setting datarank = {o.datarank}")
        if o.datasparsity is not None and o.datasparsity < 0:
            o.datasparsity = None
            _warn("Parameter datasparsity negative, using automatic selection")
        if o.initpoint < 0 or o.initpoint > 1:
            o.initpoint = 1
            _warn(f"Parameter initpoint out of range, setting initpoint = {o.initpoint}")
        _one_of("dtype", o.dtype, ("float32", "float64"))
        _one_of("nt_method", o.nt_method, ("eigh", "svd"))
        _one_of("step_eig", o.step_eig, ("auto", "exact", "chol", "lanczos", "pallas"))
        _one_of("eigh_backend", o.eigh_backend, ("jacobi", "mixed", "xla", "auto", "pallas"))
        _one_of("gemm_backend", o.gemm_backend, ("f64", "int8"))
        _one_of("chol_backend", o.chol_backend, ("auto", "f64", "mixed"))
        _one_of("cg_kernel", o.cg_kernel, ("auto", "xla", "ff", "pallas"))
        _one_of("cg_materialize", o.cg_materialize, ("auto", "never", "always"))
        _one_of("precision", o.precision, ("f64", "dd", "dd2"))
        _one_of("assembly_precision", o.assembly_precision, ("auto", "f64", "f32"))
        if o.assembly_precision == "f32" and o.precision != "f64":
            raise ValueError(
                "assembly_precision='f32' conflicts with high-precision "
                "modes (precision='dd'/'dd2')"
            )
        _one_of("nt_precision", o.nt_precision, ("auto", "f64", "dd"))
        if o.nt_precision == "dd" and o.precision != "dd2":
            raise ValueError(
                "nt_precision='dd' (native dd NT scaling) requires "
                "precision='dd2' (dd-stored iterates feed the dd "
                "factorizations)"
            )
        if o.precision in ("dd", "dd2") and o.dtype != "float64":
            raise ValueError(f"precision={o.precision!r} requires dtype='float64'")
        if o.pad_multiple < 1:
            o.pad_multiple = 1
        return o

    def resolved(self, problem, device) -> "Options":
        """A copy with every 'auto' replaced by the value it stands for on
        ``device`` (a `torch.device` or its name) for ``problem``: the JAX
        package's rules with the card in the TPU's place
        (`loraine_tpu/ipm/solver.py:252-275`, `ipm/step.py:364-370, 726,
        790-801`; `ops/eigh.py:53-58`, `ops/linalg.py:107-116`). Explicit
        values stand. The kit downgrades (`Solver`) come first."""
        o = dataclasses.replace(self)
        cuda = torch.device(device).type == "cuda"
        if o.eigh_backend == "auto":
            o.eigh_backend = "pallas"  # B1's plain version on a CPU tensor
        if o.step_eig == "auto":
            o.step_eig = "pallas"  # B2's plain version on a CPU tensor
        if o.chol_backend == "auto":
            o.chol_backend = "f64"
        if o.cg_kernel == "auto":
            o.cg_kernel = "ff" if cuda and problem.n <= 1024 else "xla"
        if o.cg_materialize == "auto":
            o.cg_materialize = "always" if problem.n <= 512 else "never"
        if o.precision != "dd2":
            o.nt_precision = "f64"  # the dd NT scaling steps from dd2 iterates only
        elif o.nt_precision == "auto":
            # the f64 NT scaling on the CG path (kit=1) on the card too
            # (ROADMAP Queue C 8)
            o.nt_precision = "dd" if cuda and o.kit == 0 else "f64"
        if o.assembly_precision == "auto":
            mixed_path = problem.nlin > 0 or any(not g.is_rank1 for g in problem.groups)
            assembles_h = o.kit == 0 or o.cg_materialize == "always"
            f32 = (o.precision == "f64" and cuda and problem.n >= 512 and mixed_path
                   and assembles_h)
            o.assembly_precision = "f32" if f32 else "f64"
        return o

    @classmethod
    def from_dict(cls, options: Optional[Dict[str, Any]] = None) -> "Options":
        """Build from a flat string-keyed dict; unknown keys raise."""
        options = dict(options or {})
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(options) - fields
        if unknown:
            raise ValueError(f"Unknown option(s): {sorted(unknown)}; known: {sorted(fields)}")
        return cls(**options)


def require_resolved(opts: Options) -> None:
    """Raise unless no option of ``opts`` is 'auto' (`Options.resolved`):
    below the solver every op reads the concrete value."""
    left = [f for f in AUTO_FIELDS if getattr(opts, f) == "auto"]
    if left:
        raise ValueError(f"option(s) {left} still 'auto': resolve them first with "
                         "Options.resolved(problem, device)")


def _one_of(name: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {list(allowed)}, got {value!r}")


def _warn(msg: str) -> None:
    warnings.warn(msg, stacklevel=3)


DEFAULT_OPTIONS = Options()

