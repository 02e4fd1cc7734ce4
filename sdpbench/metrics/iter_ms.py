"""iter_ms (ms, program span; IPM step: ipm/step.py): the window's
``Result.iteration_times`` (each step ends in a host read and a sync, so
its device work is inside) summed over their count."""


def read(run):
    times = [t for r in run.requests for t in r["iteration_times"]]
    return 1e3 * sum(times) / len(times) if times else None
