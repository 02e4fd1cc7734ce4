"""solve_s_p95 (s, host clock): the 95th percentile, interpolated between
order statistics as numpy's default does, of the wall times (build and
solve) of the window's OPTIMAL solves."""
import numpy as np


def read(run):
    walls = [r["wall_s"] for r in run.optimal]
    return float(np.percentile(walls, 95)) if walls else None
