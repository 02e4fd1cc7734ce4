"""ipm_iters (iters/solve, program counter; solver: ipm/solver.py): every
IPM iteration of the window (``Result.iterations``) over its OPTIMAL
solves, so that iterations spent on a failed solve count against it."""


def read(run):
    n = len(run.optimal)
    return sum(r["iterations"] for r in run.requests) / n if n else None
