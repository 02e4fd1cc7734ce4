#!/usr/bin/env python3
"""The program's phase spans in a `torch.profiler` trace of the window.

The port marks its phases as host ranges named ``ltt.<phase>``
(`loraine_tpu_torch/utils/timers.py:span`): ``ltt.build`` and its parts,
``ltt.solve``, ``ltt.init``, one ``ltt.step`` an IPM iteration with the
step's phases inside it, ``ltt.eig`` around the eigen-work. This module
links every device activity of the window (kernels, copies, fills) to the
host runtime call that issued it (the two share the profiler's
``correlation_id``, CUPTI's; ``linked_correlation_id`` is the host operator's
on both sides), and charges it to every ``ltt.`` span open on the main
thread at that call.
Per span name it gives:

  count       spans that began in the window
  device_s    seconds of device activity launched inside them (clipped to
              the window; a span's includes its children's)
  launches    kernel launches inside them
  waits       host waits inside them, and their seconds (waits_s): a stream,
              device or event synchronize, or a runtime copy whose device
              copy is device to host; a synchronize that directly follows
              such a copy on the host thread counts with it, once

and for the whole window: ``device_s`` (the activities' summed time),
``linked_s`` (the part linked to a runtime call), ``unattributed_s`` (the
part in no ``ltt.`` span), ``step_s`` (the ``ltt.step`` ranges' summed
duration) and ``step_busy_s`` (the union of device activity inside them),
and ``idle_gaps``: the device's idle time cut at every span edge and named
``<benchmark span>/<innermost ltt span>: <innermost host op>``.

`readings` turns that summary into per-layer numbers (rooflines by
operation against `flops.py`, the step's idle share, waits and launches an
iteration). ``python3 sdpbench/spans.py --workload <cell> --seed <n>
--seconds <s>`` runs one traced window of a cell on the card, as
``run.py --trace 1`` does, and prints `trace.reduce`'s busy share beside
this module's summary and readings as one JSON line.
"""
from __future__ import annotations

import bisect
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import flops  # noqa: E402
import peaks  # noqa: E402
import trace as trace_mod  # noqa: E402

PREFIX = "ltt."
STEP = PREFIX + "step"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch")
COPY_CALLS = ("cudaMemcpy",)


def _runtime(name: str) -> bool:
    """Whether a host event is a CUDA runtime or driver call, by its name
    (the events of torch 2.11 carry no activity type)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _covered(union: List[Tuple[int, int]], a: int, b: int, starts: List[int]) -> int:
    """Nanoseconds of the sorted disjoint ``union`` inside [a, b)."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    ns = 0
    while i < len(union) and union[i][0] < b:
        lo, hi = max(union[i][0], a), min(union[i][1], b)
        if hi > lo:
            ns += hi - lo
        i += 1
    return ns


class _Open:
    """The host ranges open on one thread, swept forward in time."""

    def __init__(self, ranges: List[Tuple[int, int, str]]):
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.ranges]
        self.stack: List[Tuple[int, int, str]] = []
        self.i = 0

    def at(self, t: int) -> List[Tuple[int, int, str]]:
        """The ranges open at ``t`` (non-decreasing across calls), outermost
        first."""
        j = bisect.bisect_right(self.starts, t)
        while self.i < j:
            r = self.ranges[self.i]
            while self.stack and self.stack[-1][1] <= r[0]:
                self.stack.pop()
            self.stack.append(r)
            self.i += 1
        while self.stack and self.stack[-1][1] <= t:
            self.stack.pop()
        return self.stack


def reduce(prof, cuda_type, window_span: str = trace_mod.WINDOW_SPAN, top: int = 12) -> Dict:
    """The span summary (module docstring) of a finished profiler ``prof``
    whose window lies inside the host range ``window_span``."""
    events = prof.profiler.kineto_results.events()
    win = next((e for e in events if e.device_type() != cuda_type and e.name() == window_span),
               None)
    if win is None:
        raise RuntimeError(f"the trace holds no {window_span} span")
    w0, w1, main = win.start_ns(), win.start_ns() + win.duration_ns(), win.start_thread_id()

    spans: List[Tuple[int, int, str]] = []  # ltt. ranges on the main thread
    host: List[Tuple[int, int, str]] = []  # every other range there, ops and calls
    calls: Dict[int, Tuple[int, int, str, int]] = {}  # correlation -> (start, dur, name, tid)
    device: List[Tuple[int, int, str, int]] = []  # (start, end, name, corr)
    for e in events:
        name = e.name()
        if e.device_type() == cuda_type:
            if name.startswith((PREFIX, trace_mod.SPAN_PREFIX)):  # device-side copies of ranges
                continue
            a, b = max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1)
            if b > a:
                device.append((a, b, name, e.correlation_id()))
            continue
        s, d, tid = e.start_ns(), e.duration_ns(), e.start_thread_id()
        if _runtime(name):
            calls[e.correlation_id()] = (s, d, name, tid)
        if tid != main or name == window_span:
            continue
        if name.startswith(PREFIX):
            spans.append((s, s + d, name))
        else:
            host.append((s, s + d, name))
    del events

    # the runtime call behind each device activity, and the copies to host
    dtoh = set()
    linked = []
    device_s = linked_s = 0.0
    for a, b, name, corr in device:
        device_s += (b - a) / 1e9
        c = corr if corr in calls else None
        if c is not None:
            linked_s += (b - a) / 1e9
            if name.startswith("Memcpy DtoH"):
                dtoh.add(c)
        linked.append((a, b, c))

    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "device_s": 0.0, "launches": 0, "waits": 0, "waits_s": 0.0})
    for s, _, name in spans:
        if w0 <= s < w1:
            out[name]["count"] += 1

    # the spans open at each runtime call on the main thread, in time order
    main_calls = sorted((s, d, name, c) for c, (s, d, name, tid) in calls.items() if tid == main)
    sweep = _Open(spans)
    path_of: Dict[int, Tuple[str, ...]] = {}
    after_copy = False
    for s, d, name, c in main_calls:
        path = tuple(dict.fromkeys(r[2] for r in sweep.at(s)))
        path_of[c] = path
        if not w0 <= s < w1:
            after_copy = False
            continue
        is_launch = name.startswith(LAUNCH_CALLS)
        is_copy = c in dtoh and name.startswith(COPY_CALLS)
        is_sync = name in SYNC_CALLS
        for p in path:
            if is_launch:
                out[p]["launches"] += 1
            if is_copy or is_sync:
                out[p]["waits_s"] += d / 1e9
                if not (is_sync and after_copy):
                    out[p]["waits"] += 1
        if is_launch or is_sync or name.startswith(COPY_CALLS):
            # calls that only query or set state leave a copy's sync its own
            after_copy = is_copy

    unattributed_s = 0.0
    for a, b, c in linked:
        path = path_of.get(c, ()) if c is not None else ()
        if not path:
            unattributed_s += (b - a) / 1e9
        for p in path:
            out[p]["device_s"] += (b - a) / 1e9

    busy = _union([(a, b) for a, b, _, _ in device])
    starts = [u[0] for u in busy]
    steps = [(max(s, w0), min(e, w1)) for s, e, name in spans if name == STEP]
    step_s = sum(max(b - a, 0) for a, b in steps) / 1e9
    step_busy_s = sum(_covered(busy, a, b, starts) for a, b in steps if b > a) / 1e9
    return {
        "spans": {k: dict(v) for k, v in sorted(out.items())},
        "device_s": device_s,
        "linked_s": linked_s,
        "unattributed_s": unattributed_s,
        "step_s": step_s,
        "step_busy_s": step_busy_s,
        "idle_gaps": _idle_gaps(busy, w0, w1, spans, host, top),
    }


def _idle_gaps(busy, w0, w1, spans, host, top) -> List[List]:
    """Seconds of device idle time in the window by the host's state: each
    gap cut at every span edge, each piece named by the benchmark span, the
    innermost ``ltt.`` span and the innermost other host range open at its
    start."""
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    edges = sorted({t for s, e, _ in spans for t in (s, e)}
                   | {t for s, e, n in host if n.startswith(trace_mod.SPAN_PREFIX) for t in (s, e)})
    ltt, other = _Open(spans), _Open(host)
    named: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        cuts = edges[bisect.bisect_right(edges, g0):bisect.bisect_left(edges, g1)]
        for p0, p1 in zip([g0, *cuts], [*cuts, g1]):
            open_host = other.at(p0)
            bench = next((h[2][len(trace_mod.SPAN_PREFIX):] for h in open_host
                          if h[2].startswith(trace_mod.SPAN_PREFIX)), "between requests")
            inner = next((h[2] for h in reversed(open_host)
                          if not h[2].startswith(trace_mod.SPAN_PREFIX)), "python")
            open_ltt = ltt.at(p0)
            where = f"{bench}/{open_ltt[-1][2]}" if open_ltt else bench
            named[f"{where}: {inner}"] += (p1 - p0) / 1e9
    return sorted(([k, v] for k, v in named.items()), key=lambda kv: -kv[1])[:top]


def readings(summary: Dict, base, datarank: int, iterations: int) -> Dict[str, Optional[float]]:
    """Per-layer numbers of one traced window: each roofline by operation is
    the least time the window's ``iterations`` need for the operation
    (`flops.py` at the instance ``base``'s shapes, over the published peak;
    for the eigen-work the larger of its float32 operations and bytes) over
    the device seconds launched in the operation's spans; ``None`` where
    the window holds nothing to read."""
    sp = summary["spans"]

    def dev(*names):
        return sum(sp.get(PREFIX + n, {}).get("device_s", 0.0) for n in names)

    def share(least_s, device_s):
        return 100.0 * least_s / device_s if device_s > 0 and iterations else None

    it = flops.iteration(base, datarank)
    jac = flops.jacobi(base)
    eig_least = max(jac["flops"] / peaks.F32_FLOPS, jac["bytes"] / peaks.HBM_BYTES)
    step = sp.get(STEP, {})
    nstep = step.get("count", 0)
    return {
        "eig_roofline": share(eig_least * iterations, dev("eig")),
        "factor_roofline": share(it["factorization"] / peaks.F64_FLOPS * iterations,
                                 dev("factor", "schur_solve")),
        "assembly_roofline": share(it["assembly"] / peaks.F64_FLOPS * iterations, dev("schur")),
        "step_idle_share": (100.0 * (1.0 - summary["step_busy_s"] / summary["step_s"])
                            if summary["step_s"] > 0 else None),
        "host_waits_per_iter": step["waits"] / nstep if nstep else None,
        "launches_per_iter": step["launches"] / nstep if nstep else None,
    }


def per_iteration_line(summary: Dict) -> str:
    """The ``#`` line: device ms an iteration by span, and the shares of the
    window's device time linked to a runtime call and to a span."""
    sp = summary["spans"]
    n = sp.get(STEP, {}).get("count", 0)
    dev = summary["device_s"]
    by = ", ".join(f"{k[len(PREFIX):]} {1e3 * v['device_s'] / n:.3f}"
                   for k, v in sorted(sp.items(), key=lambda kv: -kv[1]["device_s"])) if n else ""
    linked = 100.0 * summary["linked_s"] / dev if dev else 0.0
    spanned = 100.0 * (1.0 - summary["unattributed_s"] / dev) if dev else 0.0
    return (f"# device ms an iteration by span over {n} steps: {by}; device time linked to a "
            f"runtime call {linked:.2f}%, to an ltt. span {spanned:.2f}%")


def main(argv=None) -> int:
    import argparse
    import json
    import math
    import time

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import harness
    import instance as inst_mod

    harness.set_environment()
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; no result", file=sys.stderr)
        return 3
    ses = harness.open_session(cell, "cuda", True, log=lambda s: print(s, file=sys.stderr))
    count = int(math.ceil(args.seconds / harness.MIN_SOLVE_S)) + 1
    reqs = [inst_mod.to_program(inst, ses.ltt.SDPAData, copy=False)
            for inst in harness.instances(ses.base, args.seed, count)]
    harness._warm_profiler(torch, True)
    prof = torch.profiler.profile(activities=harness._activities(torch, True))
    torch.cuda.synchronize()
    prof.start()
    with ses.solver.span("window"):
        window_s, records = harness.run_window(ses.solver, args.seconds, reqs)
    torch.cuda.synchronize()
    prof.stop()
    t = time.perf_counter()
    events = prof.profiler.kineto_results.events()  # built once for both reductions
    prof = type("Events", (), {"profiler": type("P", (), {"kineto_results": type("K", (), {
        "events": lambda self: events})()})()})()
    base = trace_mod.reduce(prof, torch.autograd.DeviceType.CUDA)
    summary = reduce(prof, torch.autograd.DeviceType.CUDA)
    reduce_s = time.perf_counter() - t
    iters = sum(r["iterations"] for r in records)
    datarank = int(cell.options.get("datarank", 0))
    out = {
        "card": harness.card_limit(),
        "workload": cell.name, "seed": args.seed, "window_s": window_s,
        "requests": len(records), "optimal": sum(1 for r in records if r["status"] == 1),
        "iterations": iters, "reduce_s": reduce_s,
        "idle_share": 100.0 * (1.0 - base["busy_s"] / base["window_s"]),
        "busy_s": base["busy_s"], "trace_window_s": base["window_s"],
        "readings": readings(summary, ses.base, datarank, iters),
        "summary": summary,
    }
    print(per_iteration_line(summary))
    print(json.dumps(harness.finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
