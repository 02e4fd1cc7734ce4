"""One run of one cell: set-up, the measured window, the reference's
judgement and the metrics, as data that `run.py` prints.

Everything that belongs to one configuration, one workload or one metric
is in a file of its own, found by the names in ``BENCHMARK.json``:

  configs/<config>.json     the instance file, the solver options, the guarantee
  workloads/<cell>.json     the traffic: option overrides, the kernel
                            libraries to load at set-up, and the limits of
                            the numbers compared (`WORKLOAD_KEYS`)
  metrics/<metric>.py       ``read(run)`` -> a number, or None where the
                            run holds nothing to read

The loop is closed: one client, one solve at a time. Request k is the
configuration's instance under the relabeling drawn from (seed, k) (see
`instance.py`); the timed path is the program's
``problem_from_sdpa(data, datarank, dtype, device)`` then ``solve(problem,
options)``, ending in its `Result` on the host. No request starts after
``seconds``; the window ends when the last started request ends.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import instance as inst_mod
import reference
import trace as trace_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# modules the measured process may not hold, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "loraine_tpu")

# what a workload file may set; the harness runs one client in a closed
# loop, so a file that asks for anything else is refused, not ignored
WORKLOAD_KEYS = ("options", "libraries", "limits")

# the shortest solve the set-up prepares requests for: a window of S
# seconds gets S / MIN_SOLVE_S of them, and one that outruns them fails
MIN_SOLVE_S = 0.1

# the device kernels of loraine_tpu_torch/csrc/jacobi.cu (B1, B2), by their
# names in a device trace; the look-behind keeps pcg.cu's cg_cluster_kernel out
JACOBI_KERNEL = re.compile(
    r"(?<![A-Za-z0-9_])(sm|cluster|grid|round|identity|diag|gersh)_kernel\b")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    workload: dict
    chips: int

    @property
    def options(self) -> dict:
        return {**self.config["options"], **self.workload.get("options", {})}

    def limits(self) -> Dict[str, float]:
        """The limit of each number compared: the configuration's guarantee
        (status OPTIMAL at its eDIMACS) and the workload's own limits."""
        g = self.config["guarantee"]
        if g.get("status") != "OPTIMAL":
            raise ValueError(f"{self.name}: unknown guarantee {g}")
        return {"not_optimal": 0, "dimacs": float(g["eDIMACS"]),
                **{k: float(v) for k, v in self.workload.get("limits", {}).items()}}


def set_environment() -> None:
    """Before torch is imported: every cache a library may keep goes inside
    the checkout at a fixed path, no library loads JAX on its own, and the
    host's numerical libraries keep to a few threads."""
    build = os.path.join(ROOT, "build", "sdpbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(build, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def card_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi failed: {e}"


def finite(x):
    """``x`` with every non-finite float written as a string: strict JSON
    has no inf or nan."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    workload = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    unknown = sorted(set(workload) - set(WORKLOAD_KEYS))
    if unknown:
        raise SystemExit(f"workloads/{name}.json sets {unknown}: the harness knows only "
                         f"{list(WORKLOAD_KEYS)} (one client, a closed loop)")
    return Cell(name, load_json(os.path.join(root, cfg["file"])), workload, entry["chips"])


def metric_names(bench: dict, cell: str, kind: str) -> List[str]:
    """The metrics of ``kind`` ('end_to_end' or 'per_layer') that ``cell``
    reports."""
    return [m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metric(name: str, run: "Run") -> Optional[float]:
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "sdpbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    base: inst_mod.Instance  # the configuration's instance, unrelabeled
    setup_s: float
    setup_parts: Dict[str, float]
    window_s: float
    requests: List[dict]  # per request: build_s, wall_s, status, iterations, iteration_times
    trace: Optional[dict] = None  # `trace.reduce`'s summary, with --trace 1

    @property
    def optimal(self) -> List[dict]:
        return [r for r in self.requests if r["status"] == 1]


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (sys.modules by
    default), compared whole: ``loraine_tpu_torch`` is not ``loraine_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def import_program():
    """The port, from this checkout and nowhere else."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import loraine_tpu_torch as ltt

    where = os.path.dirname(os.path.dirname(os.path.abspath(ltt.__file__)))
    if os.path.realpath(where) != os.path.realpath(ROOT):
        raise SystemExit(f"loraine_tpu_torch came from {where}, not from the checkout {ROOT}")
    return ltt


class Solver:
    """The timed path: one request's build and solve, with the benchmark's
    spans around each layer's call when tracing."""

    def __init__(self, ltt, torch, cell: Cell, device: str, span: Callable,
                 options: Optional[dict] = None):
        self.ltt, self.torch, self.device, self.span = ltt, torch, device, span
        self.opts = dict(cell.options if options is None else options)
        self.datarank = int(self.opts.get("datarank", 0))
        self.dtype = torch.float32 if self.opts.get("dtype") == "float32" else torch.float64

    def __call__(self, data) -> dict:
        t0 = time.perf_counter()
        with self.span("build"):
            problem = self.ltt.problem_from_sdpa(data, datarank=self.datarank,
                                                 dtype=self.dtype, device=self.device)
        t1 = time.perf_counter()
        with self.span("solve"):
            res = self.ltt.solve(problem, self.opts, device=self.device)
        t2 = time.perf_counter()
        return {"build_s": t1 - t0, "wall_s": t2 - t0, "status": int(res.status),
                "iterations": int(res.iterations),
                "iteration_times": [float(t) for t in res.iteration_times],
                "answer": {"X": res.X, "S": res.S, "y": res.y, "X_lin": res.X_lin,
                           "objective": float(res.objective)}}


def instances(base, seed: int, count: int) -> List[inst_mod.Instance]:
    """Requests 0 .. count-1 of a run with ``seed``, relabeled from (seed, k)."""
    return [inst_mod.relabel(base, inst_mod.request_rng(seed, k)) for k in range(count)]


def run_window(solver: Solver, seconds: float, reqs: List, max_requests: Optional[int] = None):
    """The closed loop over the requests ``reqs`` made in set-up.
    Returns (window seconds, records). A window that would start a request
    past them fails: it is never extended inside the window."""
    records = []
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds and (max_requests is None or k < max_requests):
        if k == len(reqs):
            raise RuntimeError(
                f"the window outran the {len(reqs)} requests made in set-up (solves under "
                f"{MIN_SOLVE_S} s): lower harness.MIN_SOLVE_S")
        data, reqs[k] = reqs[k], None  # each request is handed over once
        records.append(solver(data))
        k += 1
    return time.perf_counter() - t0, records


def judge(cell: Cell, records: List[dict], insts) -> Dict[str, dict]:
    """Each number compared, beside its limit, over every request of the
    window: the count of solves not OPTIMAL, and the worst DIMACS sum, the
    worst infeasibility and the worst objective gap."""
    limits = cell.limits()
    per = [reference.judge(inst, rec["answer"]) for rec, inst in zip(records, insts)]
    # a window that solved nothing proves nothing: it reads one failure
    num = {"not_optimal": sum(1 for r in records if r["status"] != 1) if records else 1,
           "dimacs": max((j["dimacs"] for j in per), default=math.inf),
           "infeas": max((j["infeas"] for j in per), default=math.inf),
           "obj_gap": max((j["obj_gap"] for j in per), default=math.inf)}
    num = {k: v if v == v else math.inf for k, v in num.items()}  # nan reads inf
    return {k: {"value": num[k], "limit": limits[k]} for k in limits}


@dataclasses.dataclass
class Session:
    """A process's set-up: the program, its kernels and the warm timed path."""

    cell: Cell
    ltt: object
    torch: object
    device: str
    base: inst_mod.Instance
    solver: Solver
    parts: Dict[str, float]


def open_session(cell: Cell, device: str, trace: bool, options: Optional[dict] = None,
                 log=print) -> Session:
    """Import the program, load the cell's kernel libraries (nvcc builds
    them on a checkout's first run), parse the instance and run one warm
    solve of it; each part timed."""
    parts: Dict[str, float] = {}
    t = time.perf_counter()
    import torch

    ltt = import_program()
    parts["import"] = time.perf_counter() - t
    t = time.perf_counter()
    if device == "cuda":
        from loraine_tpu_torch.utils.cuda_build import load_library

        torch.cuda.init()
        for lib in cell.workload.get("libraries", []):
            load_library(lib)
    parts["libraries"] = time.perf_counter() - t
    t = time.perf_counter()
    base = inst_mod.read_sdpa(os.path.join(ROOT, cell.config["instance"]))
    parts["parse"] = time.perf_counter() - t
    span = _spans(torch) if trace else (lambda name: contextlib.nullcontext())
    solver = Solver(ltt, torch, cell, device, span, options)
    t = time.perf_counter()
    warm = solver(inst_mod.to_program(base, ltt.SDPAData))
    parts["warm_solve"] = time.perf_counter() - t
    if warm["status"] != 1:
        log(f"# the warm solve of the published instance ended in status {warm['status']}")
    return Session(cell, ltt, torch, device, base, solver, parts)


def measure(ses: Session, seed: int, seconds: float, max_requests: Optional[int] = None,
            trace: bool = False, t_start: Optional[float] = None, log=print):
    """Relabel, then run the window. Returns (set-up seconds from
    ``t_start``, window seconds, records, instances, trace summary, peak
    device bytes, forbidden modules found after the window)."""
    torch, cuda = ses.torch, ses.device == "cuda"
    t = time.perf_counter()
    count = max_requests or int(math.ceil(seconds / MIN_SOLVE_S)) + 1
    # handed over whole: the reference makes its own copies after the window
    reqs = [inst_mod.to_program(inst, ses.ltt.SDPAData, copy=False)
            for inst in instances(ses.base, seed, count)]
    ses.parts["relabel"] = time.perf_counter() - t
    prof = None
    if trace:
        _warm_profiler(torch, cuda)
        prof = torch.profiler.profile(activities=_activities(torch, cuda))
    if cuda:
        torch.cuda.synchronize()
    setup_s = None if t_start is None else time.perf_counter() - t_start
    if prof is not None:
        prof.start()
    with ses.solver.span("window"):
        window_s, records = run_window(ses.solver, seconds, reqs, max_requests)
    if prof is not None:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    del reqs
    insts = instances(ses.base, seed, len(records))  # the reference's own copies, made anew
    summary = None
    if prof is not None:
        t = time.perf_counter()
        summary = trace_mod.reduce(prof, torch.autograd.DeviceType.CUDA)
        log(f"# trace reduced in {time.perf_counter() - t:.3f} s")
    return setup_s, window_s, records, insts, summary, peak, found


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, bench: dict, log=print,
             max_requests: Optional[int] = None) -> dict:
    """One run of ``cell``; returns the result's fields. ``t_start`` is
    the process's start on the host clock (set-up counts from there)."""
    ses = open_session(cell, device, trace, log=log)
    setup_s, window_s, records, insts, summary, peak, found = measure(
        ses, seed, seconds, max_requests, trace, t_start, log)
    cuda = device == "cuda"
    if cuda:
        ses.torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = judge(cell, records, insts)
    log(f"# reference: {len(records)} answers judged in {time.perf_counter() - t:.3f} s")
    for r in records:
        del r["answer"]
    run = Run(cell, ses.base, setup_s, ses.parts, window_s, records, summary)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name in metric_names(bench, cell.name, kind):
        value = read_metric(name, run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    correct = not found and all(c["value"] <= c["limit"] for c in checks.values())
    out = {
        "correct": bool(correct),
        "attempted": len(records),
        "failed": sum(1 for r in records if r["status"] != 1),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": ses.torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips if cuda else 0,
                   "memory_peak_bytes": int(peak)},
    }
    if summary is not None:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = checks
    out["_forbidden"] = found
    out["_run"] = run
    return out


def _spans(torch):
    def span(name):
        return torch.profiler.record_function(trace_mod.SPAN_PREFIX + name)
    return span


def _activities(torch, cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _warm_profiler(torch, cuda: bool) -> None:
    """Start and stop the profiler once in set-up: its first start
    initializes the device tracer, which would otherwise fall in the window."""
    with torch.profiler.profile(activities=_activities(torch, cuda)):
        x = torch.ones(8, device="cuda" if cuda else "cpu")
        (x + x).sum().item()
