"""solve_s (s, host clock): the window's seconds over the solves that
ended OPTIMAL in it; time to a solution of the stated accuracy, the
problem's build included."""


def read(run):
    n = len(run.optimal)
    return run.window_s / n if n else None
