"""build_ms (ms, host clock; front end: problem.py, io/sdpa.py): the
window's time in ``problem_from_sdpa`` over its requests."""


def read(run):
    n = len(run.requests)
    return 1e3 * sum(r["build_s"] for r in run.requests) / n if n else None
