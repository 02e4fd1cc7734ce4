"""A cell at a size a CPU test run holds, for the tests of the harness.

Its limits were set the way the benchmark's are, from CPU readings of
the program and of its controls on relabeled tru3, the worst over three
solves a seed on 12 seeds (three for the float32 path): float64,
infeasibility 3.3e-15 to 6.7e-15 and objective gap 0; the answers held
in float32, 1.8e-7 to 9.4e-7 and 3.9e-9; the float32 path, 1.4e-6 to
3.0e-6 and 4.6e-9 to 6.2e-9."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SDPBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(SDPBENCH)
for p in (SDPBENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

THETA1 = os.path.join(HERE, "instances", "theta1-sdplib.dat-s")
TRU3 = os.path.join(HERE, "instances", "tru3-loraine.dat-s")


def cell() -> harness.Cell:
    """tru3 under the options of tru9's cell, its limits from CPU readings."""
    cfg = {"instance": os.path.relpath(TRU3, ROOT),
           "options": {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "verb": 0},
           "guarantee": {"status": "OPTIMAL", "eDIMACS": 1e-5}}
    wl = {"libraries": [], "limits": {"infeas": 1e-10, "obj_gap": 1e-12}}
    return harness.Cell("test.tru3", cfg, wl, 1)
