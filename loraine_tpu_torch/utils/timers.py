"""Lightweight phase timers. Port of `loraine_tpu/utils/timers.py`: named
phases with accumulated wall time and call counts, printable as a table.

A phase measures host wall time. Callers that time device work synchronise
inside the phase (`Solver.solve` does so on CUDA)."""
from __future__ import annotations

import contextlib
import time
from typing import Dict


class PhaseTimer:
    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
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
