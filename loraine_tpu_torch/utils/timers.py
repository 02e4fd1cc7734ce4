"""Lightweight phase timers and the solve's trace spans. Port of
`loraine_tpu/utils/timers.py`: named phases with accumulated wall time and
call counts, printable as a table.

A phase measures host wall time. Callers that time device work synchronise
inside the phase (`Solver.solve` does so on CUDA).

`span(name)` marks a phase of the build or the solve in a `torch.profiler`
trace as the host range ``ltt.<name>``; spans nest on the host thread, so
every span of one solve lies inside its ``ltt.solve``. A span exists only
while a profiler records (an operator's ``profile_dir``, or any caller's
`torch.profiler.profile`); otherwise `span` returns one shared null context
and costs one flag read. The range is an operator-scope `RecordFunction`:
the device work launched inside it is linked to it through the profiler's
correlation ids, and it adds no device-side range of its own to the trace.
A `PhaseTimer` phase opens the span of its phase around its timing."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

PREFIX = "ltt."
_NULL = contextlib.nullcontext()


def span(name: str):
    """The trace range ``ltt.<name>`` while a profiler records, else a
    shared null context."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _NULL


class PhaseTimer:
    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, span_name: Optional[str] = None):
        """Time the phase ``name`` inside the span ``span_name`` (default
        ``name``)."""
        with span(span_name or name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.seconds[name] = self.seconds.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        if not self.seconds:
            return ""
        width = max(len(k) for k in self.seconds)
        lines = [f" {'phase'.ljust(width)}   calls     time"]
        for k in sorted(self.seconds, key=lambda k: -self.seconds[k]):
            lines.append(
                f" {k.ljust(width)}  {self.counts[k]:6d} {self.seconds[k]:8.3f}s"
            )
        return "\n".join(lines)
