"""Solver options. Port of `loraine_tpu/config.py`.

Same names, defaults and validation/auto-correction as the JAX package (which
mirrors Loraine.jl `src/Solvers.jl:169-302`). Every value the JAX package
accepts is accepted here too; `require_ported` then names the values this
port does not run yet, and `Solver` raises `NotImplementedError` for them.

What the port runs: ``kit`` 0 and 1, ``precision='f64'``,
``dtype='float64'``, ``nt_method='eigh'``, ``eigh_backend``/``step_eig`` in
'auto'/'pallas', ``chol_backend`` 'auto'/'f64', ``gemm_backend='f64'``,
``assembly_precision='f64'``, and every ``cg_kernel`` / ``cg_materialize``
value. In the port 'pallas' means the hand-written Jacobi kernels of
`ops/jacobi.py` (CUDA C++ in `csrc/jacobi.cu`), and 'auto' resolves to them
on every device; on a CPU tensor they run their plain PyTorch version, so
CPU and card runs take the same algorithmic path.

``cg_kernel`` (materialized CG route only, `resolve_cg_kernel`): 'ff' is the
single-launch f64 CG kernel B3 and 'pallas' the f32 CG kernel B4
(`ops/pcg.py`, CUDA C++ in `csrc/pcg.cu`); on a CPU tensor each runs its
plain PyTorch version. 'xla' is the eager f64 CG of `ops/cg.py`. 'auto' is
'ff' on a CUDA device for n <= 1024 and 'xla' otherwise, as the JAX package
picks 'ff' on the TPU and 'xla' on the CPU.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional


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
    gemm_backend: str = "f64"
    chol_backend: str = "auto"
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

    @classmethod
    def from_dict(cls, options: Optional[Dict[str, Any]] = None) -> "Options":
        """Build from a flat string-keyed dict; unknown keys raise."""
        options = dict(options or {})
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(options) - fields
        if unknown:
            raise ValueError(f"Unknown option(s): {sorted(unknown)}; known: {sorted(fields)}")
        return cls(**options)


# option -> (values the port runs, ROADMAP item that ports the rest)
_PORTED = {
    "kit": ((0, 1), "Queue A item 11 (CG path)"),
    "precision": (("f64",), "Queue A item 12 (precision tiers)"),
    "dtype": (("float64",), "Queue A item 13 (remaining option values)"),
    "nt_method": (("eigh",), "Queue A item 13 (remaining option values)"),
    "eigh_backend": (("auto", "pallas"), "Queue A item 13 (remaining option values)"),
    "step_eig": (("auto", "pallas"), "Queue A item 13 (remaining option values)"),
    "chol_backend": (("auto", "f64"), "'Not carried over' (f32-panel Cholesky)"),
    "gemm_backend": (("f64",), "'Not carried over' (int8 Ozaki GEMM)"),
    "assembly_precision": (("f64",), "Queue A item 13 (remaining option values)"),
    "nt_precision": (("auto", "f64"), "Queue A item 12 (precision tiers)"),
    "profile_dir": (("",), "Queue A item 15 (diagnostics)"),
}


def require_ported(o: Options) -> None:
    """Raise NotImplementedError for an option value this port does not run
    yet, naming the ROADMAP item that will port it."""
    for name, (ok, item) in _PORTED.items():
        v = getattr(o, name)
        if v not in ok:
            raise NotImplementedError(
                f"{name}={v!r} is not ported to loraine_tpu_torch yet "
                f"(runs: {list(ok)}); see ROADMAP.md {item}"
            )
    if o.timing >= 2:
        raise NotImplementedError(
            "timing>=2 (per-phase re-timing) is not ported to "
            "loraine_tpu_torch yet; see ROADMAP.md Queue A item 15 (diagnostics)"
        )


def resolve_cg_kernel(cg_kernel: str, n: int, device) -> str:
    """The CG solver of the materialized route (`ipm/step.py:790-801` of the
    JAX package, with the card in the TPU's place): 'auto' is the B3 kernel
    ('ff') on a CUDA device up to n = 1024, else the f64 'xla' loop."""
    if cg_kernel != "auto":
        return cg_kernel
    return "ff" if device.type == "cuda" and n <= 1024 else "xla"


def _one_of(name: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {list(allowed)}, got {value!r}")


def _warn(msg: str) -> None:
    warnings.warn(msg, stacklevel=3)

