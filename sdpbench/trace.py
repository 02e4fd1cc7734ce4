"""Reduce a `torch.profiler` trace of the measured window to what the
per-layer readers and the result's ``breakdown`` use.

It reads the profiler's raw events (`kineto_results.events()`); at the
window's ~10^5-10^6 device activities `key_averages()` takes minutes.

Busy time is the union of the device activities' intervals (kernels,
copies, fills) inside the window, so it never exceeds the wall; on one
stream it equals their sum, which is the arithmetic of the busy share in
`loraine_tpu_torch/utils/profiling.py` (`traced`, "busy share = device
time over the traced wall"). The device's idle time is named by what the
host was doing: the benchmark's span around the call (``build`` or
``solve``, cut where one ends) and the innermost operation the profiler
recorded on the host thread at the start of each piece.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

SPAN_PREFIX = "sdpbench."
WINDOW_SPAN = SPAN_PREFIX + "window"


def _short(name: str, width: int = 120) -> str:
    """A kernel's name without ``void`` and its argument list, at most
    ``width`` letters."""
    s = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and not s.startswith("(anonymous namespace)", i):
            s = s[:i]
            break
    return s.strip()[:width]


def reduce(prof, cuda_type, top: int = 10) -> Dict:
    """The window's device busy time, its kernels by name and its idle gaps
    by host activity, from a finished `torch.profiler.profile` ``prof``
    whose window lies inside a `WINDOW_SPAN` annotation."""
    rows = [(e.device_type() == cuda_type, e.name(), e.start_ns(), e.duration_ns(),
             e.start_thread_id()) for e in prof.profiler.kineto_results.events()]
    span = next((r for r in rows if not r[0] and r[1] == WINDOW_SPAN), None)
    if span is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1, main_thread = span[2], span[2] + span[3], span[4]
    host: List[Tuple[int, int, str]] = []
    device: List[Tuple[int, int]] = []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for on_device, name, s, d, tid in rows:
        if on_device:
            if name.startswith(SPAN_PREFIX):  # the spans' GPU-side copies
                continue
            a, b = max(s, w0), min(s + d, w1)
            if b > a:
                device.append((a, b))
                k = kernels[name]
                k[0] += (b - a) / 1e9
                k[1] += 1
        elif tid == main_thread and name != WINDOW_SPAN:
            host.append((s, s + d, name))
    del rows
    device.sort()
    busy_ns, gaps = 0, []
    cur_a, cur_b = None, None
    edge = w0
    for a, b in device:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy_ns += cur_b - cur_a
            if a > edge:
                gaps.append((edge, a))
            cur_a, cur_b = a, b
            edge = b
        else:
            cur_b = max(cur_b, b)
            edge = cur_b
    if cur_b is not None:
        busy_ns += cur_b - cur_a
    if w1 > edge:
        gaps.append((edge, w1))
    idle = _name_gaps(gaps, host)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": {name: (sec, int(n)) for name, (sec, n) in kernels.items()},
        "device_ops": [[_short(name), sec] for name, (sec, _) in ranked[:top]],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:top],
    }


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of device idle time by host activity: each gap cut where a
    ``sdpbench.`` span begins or ends, each piece named by the innermost
    host event open at its start, under its span."""
    host.sort(key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    edges = sorted(t for h in host if h[2].startswith(SPAN_PREFIX) for t in h[:2])
    out: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for g0, g1 in gaps:  # gaps come in time order, and so do their pieces
        cuts = edges[bisect.bisect_right(edges, g0):bisect.bisect_left(edges, g1)]
        for p0, p1 in zip([g0, *cuts], [*cuts, g1]):
            # open every host event that began by p0, closing those that ended
            j = bisect.bisect_right(starts, p0)
            while i < j:
                ev = host[i]
                while stack and stack[-1][1] <= ev[0]:
                    stack.pop()
                stack.append(ev)
                i += 1
            while stack and stack[-1][1] <= p0:
                stack.pop()
            span = next((h[2][len(SPAN_PREFIX):] for h in stack if h[2].startswith(SPAN_PREFIX)),
                        "between requests")
            inner = stack[-1][2] if stack and not stack[-1][2].startswith(SPAN_PREFIX) else "python"
            out[f"{span}: {inner}"] += (p1 - p0) / 1e9
    return out
