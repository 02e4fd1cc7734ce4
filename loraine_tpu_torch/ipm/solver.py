"""Host-side IPM loop. Port of `loraine_tpu/ipm/solver.py` (`Solver`,
`Result`, `solve`, `load_problem`, `solve_sdpa`).

Mirrors the reference's `solve` loop (`src/Solvers.jl:304-361`). PyTorch
runs eagerly, so the port steps once per host iteration: no jit, no
K-iteration chunks, no compile cache. The status precedence is the one
`build_chunk` applies on the device (`ipm/step.py:1353-1430`): H not
factorizable or regcount > 5 -> 3, NT scaling failed -> 4, non-finite
DIMACS -> 3, DIMACS < eDIMACS -> 1, DIMACS > 1e55 -> 2, |obj| > 1e55 -> 3,
maxit -> 4. On the CG path (kit=1) the loop also carries the CG tolerance
schedule and the hybrid preconditioner switch (4 -> 1), as the JAX
package's chunk does (`ipm/step.py:1393-1413`).

The solver owns the route: after the kit downgrades it resolves every
'auto' option once (`Options.resolved`, `config.py`) into ``Solver.route``,
which every step reads; ``Solver.opts`` keeps the user's values.

assembly_precision (`loraine_tpu/ipm/solver.py:248-273, 359-366`): 'f32'
assembles the Schur matrix in f32 from the first iteration, 'auto' does so
on a CUDA device (the card in the TPU's place) for n >= 512 when a group is
not rank-1 or there is an LP block and the step assembles H (kit=0, or the
kit=1 materialized route), and 'f64' never; the precision tiers never do.
After the first iteration whose DIMACS falls below
`MIXED_ASSEMBLY_DIMACS` = 1e-3 with status 0, the loop hands over to the
exact assembly for good (the JAX package's `mixed_off` signal); the
result's ``mixed_handover`` names that iteration.

``timing >= 2`` (with ``verb > 0``) prints the per-phase table of
`utils/diagnostics.py` after the solve, and ``profile_dir`` records the
solve with `torch.profiler` (CUDA activity included on a card) into a
trace file in that directory: the port's counterparts of the JAX package's
`profile_phases` re-timing and `jax.profiler.trace`
(`loraine_tpu/ipm/solver.py:215-218, 390-392, 406-415`). Under any
profiler the solve marks its phases as spans (`utils/timers.py:span`):
``ltt.solve`` around it, ``ltt.init`` (the initial point), one ``ltt.step``
an iteration (the step's own spans, `ipm/step.py`, then ``ltt.stats``, the
host read of its stats and the sync) and ``ltt.result`` (the host copies
of the `Result`).

On a sharded problem (`parallel/mesh.py`: every rank runs this loop on its
own slice) the host reads every decision (status, the regularization
count, the hybrid switch, the f32-assembly handover, the CG tolerance)
from stats that rank 0 broadcast (`StepStats.to_host`), so the ranks never
branch apart, and the `Result` carries the whole X and S on every rank, as
the JAX package's process-allgather `_fetch` does
(`loraine_tpu/ipm/solver.py:59-67`).

Status codes (reference `src/MOI_wrapper.jl:252-265`):
  0 = not solved, 1 = optimal, 2 = (probably) infeasible,
  3 = (probably) unbounded or infeasible, 4 = iteration/numerics limit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..config import Options
from ..ops.schur import gather_blocks
from ..problem import SDPProblem, problem_from_sdpa
from ..utils.device import resolve_device
from ..utils.timers import PhaseTimer, span
from .initial import initial_point
from .state import IPMState
from .step import step

# DIMACS below which the f32 Schur assembly hands over to the exact one
# (`loraine_tpu/ipm/step.py:1343`)
MIXED_ASSEMBLY_DIMACS = 1e-3

__all__ = ["Result", "Solver", "solve", "solve_sdpa", "solve_json", "load_problem",
           "STATUS_NAMES"]

STATUS_NAMES = {
    0: "NOT_SOLVED",
    1: "OPTIMAL",
    2: "INFEASIBLE",
    3: "INFEASIBLE_OR_UNBOUNDED",
    4: "ITERATION_LIMIT",
}

OptionsLike = Union[Options, Dict[str, Any], None]


def _options(options: OptionsLike) -> Options:
    if isinstance(options, dict) or options is None:
        options = Options.from_dict(options)
    return options.validated()


@dataclasses.dataclass
class Result:
    """Solution container (reference result surface:
    `src/MOI_wrapper.jl:241-354`)."""

    status: int
    status_name: str
    objective: float  # -b^T y + b_const (SDPA-sense optimal value)
    dual_objective: float  # -sum <C_i, X_i> - d_lin^T x_lin
    y: np.ndarray
    X: List[np.ndarray]  # primal blocks, original order/sizes (unpadded)
    S: List[np.ndarray]  # dual slack blocks, original order/sizes
    X_lin: Optional[np.ndarray]
    iterations: int
    cg_iterations: int
    dimacs: float
    errs: Dict[str, float]
    solve_time: float
    iteration_times: List[float]  # per iteration, device work included
    timer: PhaseTimer
    final_state: Optional[IPMState] = None  # for warm-start; dd2: with its tails
    history: Optional[List[Dict[str, float]]] = None  # per-iteration stats
    # the last iteration of the f32 Schur assembly before the handover to
    # f64 (None: no handover, or no f32 assembly)
    mixed_handover: Optional[int] = None


class Solver:
    def __init__(
        self,
        problem: SDPProblem,
        options: OptionsLike = None,
        initial_state: Optional[IPMState] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        """``device`` must be where ``problem`` lives ('cuda' by default; it
        raises without a card). ``initial_state`` warm-starts the IPM from a
        saved iterate; shapes must match the problem."""
        self.device = resolve_device(device)
        if problem.device.type != self.device.type:
            raise ValueError(
                f"problem lives on {problem.device}, solver device is {self.device}"
            )
        self.problem = problem
        self.opts = _options(options)
        self.timer = PhaseTimer()
        self.initial_state = initial_state
        self.mesh = problem.mesh  # set by `parallel.mesh.shard_problem`
        self._apply_auto_downgrades()
        # what the solve runs: every 'auto' resolved (`Options.resolved`);
        # ``opts`` keeps the user's values for the header and the result
        self.route = self.opts.resolved(problem, self.device)

    def _apply_auto_downgrades(self) -> None:
        """kit auto-downgrades (`src/Solvers.jl:421-444`)."""
        o, p = self.opts, self.problem
        if o.kit == 1:
            if p.nlmi == 0:
                warnings.warn("Switching to a direct solver, no LMIs")
                o.kit = 0
            elif o.erank >= max(g.m for g in p.groups) - 1:
                warnings.warn("Switching to a direct solver, erank bigger than matrix size")
                o.kit = 0

    def _normalize_tails(self, state: IPMState) -> IPMState:
        """Reconcile the state's dd2 tails with the requested precision
        (`loraine_tpu/ipm/solver.py:128-151`): under 'dd2' a state without
        tails gets zero tails (exact: the f64 iterate is hi + 0), and at
        any other precision the tails are dropped (the hi words are the
        correctly rounded f64 iterate).

        The dd2 sparse setup of the JAX package (`ensure_dd_aadj`, `:239-247`)
        has no counterpart: the sparse dd adjoint reduces over the
        `AdjLayout` every sparse group carries from load time."""
        if self.opts.precision == "dd2":
            if state.X_lo is None:
                def zeros(x):
                    return None if x is None else torch.zeros_like(x)

                state = dataclasses.replace(
                    state,
                    X_lo=tuple(torch.zeros_like(X) for X in state.X),
                    S_lo=tuple(torch.zeros_like(S) for S in state.S),
                    y_lo=torch.zeros_like(state.y),
                    X_lin_lo=zeros(state.X_lin),
                    S_lin_lo=zeros(state.S_lin),
                )
        elif state.X_lo is not None:
            state = dataclasses.replace(state, X_lo=None, S_lo=None, y_lo=None,
                                        X_lin_lo=None, S_lin_lo=None)
        return state

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- logging ----------------------------------------------------------
    def _header(self) -> None:
        o, p = self.opts, self.problem
        if o.verb <= 0:
            return
        print(" *** loraine_tpu_torch ***")
        print(f" Number of variables: {p.n:5d}")
        print(f" LMI constraints    : {p.nlmi:5d}")
        if p.nlmi > 0:
            sizes = []
            for g in p.groups:
                sizes += list(g.orig_sizes)
            print(" Matrix size(s)     :" + "".join(f"{s:6d}" for s in sizes))
        print(f" Linear constraints : {p.nlin:5d}")
        if o.kit > 0:
            print(f" Preconditioner     : {o.preconditioner:5d}")
        else:
            print(" Preconditioner     :  none, using direct solver")
        print(" *** IP STARTS")
        cg = "   cg_iter" if o.kit == 1 else ""
        if o.verb < 2:
            print(f" it        obj         error  {cg}   CPU/it")
        else:
            cg = "    cg_pre  cg_cor" if o.kit == 1 else ""
            print(f" it        obj         error      err1      err2      err3      err4      err5      err6 {cg}    CPU/it")

    def _log_iter(self, it: int, s: Dict[str, float], dt: float) -> None:
        o = self.opts
        if o.verb <= 0:
            return
        if o.verb > 1:
            cg = f" {s['cg_pre']:7d} {s['cg_cor']:7d}" if o.kit == 1 else ""
            print(f"{it:3d} {s['obj']:16.8e} {s['dimacs']:9.2e} {s['err1']:9.2e} {s['err2']:9.2e} {s['err3']:9.2e} {s['err4']:9.2e} {s['err5']:9.2e} {s['err6']:9.2e}{cg} {dt:8.2f}")
        else:
            cg = f" {s['cg_pre'] + s['cg_cor']:9d}" if o.kit == 1 else ""
            print(f"{it:3d} {s['obj']:16.8e} {s['dimacs']:9.2e}{cg} {dt:8.2f}")

    # -- main loop --------------------------------------------------------
    def solve(self) -> Result:
        o = self.opts
        with self._profiler(o.profile_dir) if o.profile_dir else contextlib.nullcontext():
            with span("solve"):
                result = self._solve()
        if o.timing > 0 and o.verb > 0:
            print(self.timer.report())
        if o.timing >= 2 and o.verb > 0:
            # the per-phase attribution (the reference's TimerOutputs tree,
            # `src/Solvers.jl:467-476`): re-times each phase standalone at a
            # representative iterate, so it costs extra device work
            from ..utils.diagnostics import format_phases, profile_phases

            print(format_phases(profile_phases(self.problem, o), self.device.type))
        return result

    def _solve(self) -> Result:
        o, r, p = self.opts, self.route, self.problem
        t_start = time.perf_counter()
        self._header()

        with self.timer.phase("initial point", "init"):
            state = self.initial_state if self.initial_state is not None else initial_point(p, o)
            state = self._normalize_tails(state)

        status = 0
        it = 0
        regcount = 0
        cg_tot = 0
        tol_cg = o.tol_cg
        precond_kind = o.preconditioner if o.kit == 1 else -1
        mixed = r.assembly_precision == "f32"
        handover = None
        stats_h: Dict[str, Any] = {}
        iteration_times: List[float] = []
        history: List[Dict[str, float]] = []

        while status == 0:
            t0 = time.perf_counter()
            with self.timer.phase("ipm step", "step"):
                state, stats = step(p, state, r, tol_cg, precond_kind, mixed)
                with span("stats"):
                    stats_h = stats.to_host(self.mesh)  # waits for the step's device work
                    self._sync()
            dt = time.perf_counter() - t0
            it += 1
            iteration_times.append(dt)
            stats_h["cg_pre"] = stats_h.pop("cg_iter_pre")
            stats_h["cg_cor"] = stats_h.pop("cg_iter_cor")
            cg_tot += stats_h["cg_pre"] + stats_h["cg_cor"]
            history.append({k: stats_h[k] for k in (
                "obj", "mu", "err1", "err2", "err3", "err4", "err5", "err6",
                "dimacs", "cg_pre", "cg_cor")})
            status = self._status(stats_h, it, regcount)
            # tol_cg schedule (`loraine_tpu/ipm/step.py:1413`)
            tol_cg = max(tol_cg * o.tol_cg_up, o.tol_cg_min)
            if stats_h["h_shifts"] > 0:
                regcount += 1
            if stats_h["h_ok"] and stats_h["nt_ok"] and math.isfinite(stats_h["dimacs"]) \
                    and not (stats_h["h_shifts"] > 0 and regcount > 5):
                self._log_iter(it, stats_h, dt)
            if o.verb > 0 and status in (2, 3, 4):
                if status == 2:
                    print("WARNING: Problem probably infeasible (stopping status = 2)")
                elif status == 3 and abs(stats_h["obj"]) > 1e55:
                    print("WARNING: Problem probably unbounded or infeasible (stopping status = 3)")
                elif status == 4 and it >= o.maxit:
                    print("WARNING: Stopped by iteration limit (stopping status = 4)")
            if status == 0 and mixed and stats_h["dimacs"] < MIXED_ASSEMBLY_DIMACS:
                # hand over to the exact f64 assembly near convergence
                mixed, handover = False, it
                if o.verb > 0:
                    print("Switching to exact f64 Schur assembly")
            if status == 0 and precond_kind == 4 and self._hybrid_switch(stats_h["cg_cor"], it):
                # hybrid preconditioner switch (src/Solvers.jl:339-347)
                precond_kind = 1
                o.aamat = r.aamat = 2
                if o.verb > 0:
                    print("Switching to preconditioner 1")

        solve_time = time.perf_counter() - t_start
        if o.verb > 0:
            if o.kit == 1:
                print(f" *** Total CG iterations: {cg_tot:8d}")
            if status == 1:
                print(f" *** Optimal solution found in {solve_time:8.2f} seconds")

        with span("result"):
            result = self._extract(state, stats_h, status, it, cg_tot, solve_time,
                                   iteration_times)
        result.history = history
        result.mixed_handover = handover
        if o.verb > 0 and status == 1:
            print(f"Primal objective: {result.objective}")
            print(f"Dual objective:   {result.dual_objective}")
        return result

    def _profiler(self, profile_dir: str):
        """A `torch.profiler` context whose trace lands in ``profile_dir``
        (one ``*.pt.trace.json`` per solve, TensorBoard's layout, as
        `jax.profiler.trace` writes its own there)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir),
        )

    def _status(self, s: Dict[str, Any], it: int, regcount: int) -> int:
        """Status after one iteration, in `build_chunk`'s precedence; prints
        the reference's warnings (src/predictor_corrector.jl:55-97)."""
        o = self.opts
        say = print if o.verb > 0 else (lambda *_: None)
        if not s["h_ok"]:
            say("WARNING: H cannot be made positive definite, giving up")
            return 3
        if s["h_shifts"] > 0:
            say("Matrix H not positive definite, regularized")
            if regcount + 1 > 5:
                say("WARNING: too many regularizations of H, giving up")
                return 3
        if not s["nt_ok"]:
            say("WARNING: X or S cannot be made positive definite, giving up")
            return 4
        dimacs = s["dimacs"]
        if not math.isfinite(dimacs):
            say("WARNING: numerical breakdown (non-finite error), giving up")
            return 3
        if dimacs < o.eDIMACS:
            return 1
        if dimacs > 1e55:
            return 2
        if abs(s["obj"]) > 1e55:
            return 3
        if it >= o.maxit:
            return 4
        return 0

    def _hybrid_switch(self, cg_cor: int, it: int) -> bool:
        """Preconditioner 4 hands over from H_beta to H_alpha once the
        corrector's CG count passes the reference's threshold
        (`loraine_tpu/ipm/step.py:1393-1399`)."""
        p = self.problem
        thresh = self.opts.erank * p.nlmi * math.sqrt(p.n) / 20.0
        return (cg_cor / 2.0 > thresh and it > math.sqrt(p.n) / 60.0) or cg_cor > 100

    def _extract(self, state, stats_h, status, it, cg_tot, solve_time, iteration_times) -> Result:
        p = self.problem
        Xb: List[Optional[np.ndarray]] = [None] * p.nlmi
        Sb: List[Optional[np.ndarray]] = [None] * p.nlmi
        trCX = 0.0
        for g, Xg, Sg in zip(p.groups, state.X, state.S):
            Xh = gather_blocks(g, Xg).cpu().numpy()
            Sh = gather_blocks(g, Sg).cpu().numpy()
            trCX += float(np.sum(gather_blocks(g, g.C).cpu().numpy() * Xh))
            for bpos, (oidx, osize) in enumerate(zip(g.orig_indices, g.orig_sizes)):
                Xb[oidx] = Xh[bpos, :osize, :osize]
                Sb[oidx] = Sh[bpos, :osize, :osize]
        y = state.y.cpu().numpy()
        X_lin = None if state.X_lin is None else state.X_lin.cpu().numpy()
        dual_obj = -trCX
        if p.nlin > 0:
            dual_obj -= float(np.dot(p.d_lin.cpu().numpy(), X_lin))
        return Result(
            status=status,
            status_name=STATUS_NAMES.get(status, "UNKNOWN"),
            objective=float(-np.dot(p.b.cpu().numpy(), y) + p.b_const),
            dual_objective=dual_obj,
            y=y,
            X=Xb,
            S=Sb,
            X_lin=X_lin,
            iterations=it,
            cg_iterations=cg_tot,
            dimacs=stats_h.get("dimacs", float("nan")),
            errs={k: stats_h.get(k, float("nan")) for k in ("err1", "err2", "err3", "err4", "err5", "err6")},
            solve_time=solve_time,
            iteration_times=iteration_times,
            timer=self.timer,
            final_state=state,
        )


def solve(problem: SDPProblem, options: OptionsLike = None,
          device: Union[str, torch.device] = "cuda") -> Result:
    """Solve an SDPProblem on ``device`` (where the problem lives)."""
    return Solver(problem, options, device=device).solve()


def load_problem(path: str, options: OptionsLike = None,
                 device: Union[str, torch.device] = "cuda") -> SDPProblem:
    """Read an SDPA .dat-s file into an SDPProblem on ``device`` with the
    JAX package's option-driven storage selection (datarank, padding,
    datasparsity: None = modeled-cost auto choice, 0 = force dense,
    k > 0 = explicit nnz threshold at any n)."""
    options = _options(options)
    dtype = torch.float64 if options.dtype == "float64" else torch.float32
    ds = options.datasparsity
    if ds == 0:
        storage, thr, min_n = "dense", None, 256
    elif ds is None:
        storage, thr, min_n = "auto", None, 256
    else:
        storage, thr, min_n = "auto", int(ds), 0
    return problem_from_sdpa(
        path,
        datarank=options.datarank,
        pad_multiple=options.pad_multiple,
        dtype=dtype,
        storage=storage,
        sparse_max_nnz=thr,
        sparse_min_n=min_n,
        device=device,
    )


def solve_sdpa(path: str, options: OptionsLike = None,
               device: Union[str, torch.device] = "cuda") -> Result:
    """Read an SDPA .dat-s file and solve it on ``device``."""
    options = _options(options)
    device = resolve_device(device)
    problem = load_problem(path, options, device=device)
    return Solver(problem, options, device=device).solve()


def solve_json(path: str, options: OptionsLike = None,
               device: Union[str, torch.device] = "cuda") -> Result:
    """Read a POEMA-JSON problem and solve it on ``device``
    (`loraine_tpu/ipm/solver.py:solve_json`; the working replacement for the
    reference's `TBD/solve_json.jl` flow over the broken raw-dict entry,
    `src/Loraine.jl:30-93`)."""
    from ..io.poema import read_poema_json
    from ..problem import problem_from_dict

    options = _options(options)
    device = resolve_device(device)
    dtype = torch.float64 if options.dtype == "float64" else torch.float32
    problem = problem_from_dict(read_poema_json(path), datarank=options.datarank,
                                pad_multiple=options.pad_multiple, dtype=dtype, device=device)
    return Solver(problem, options, device=device).solve()
