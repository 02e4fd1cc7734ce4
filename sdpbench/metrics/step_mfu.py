"""step_mfu (%, program span; IPM step: ipm/step.py): the operations the
window's IPM iterations need (`flops.iteration` at the instance's shapes,
times the iterations) over their time (``Result.iteration_times``), as a
share of the card's 67 TFLOP/s, the f64 tensor-core and the f32 peak
alike. It bounds every kernel's roofline share of the step: a kernel
taken off the path leaves its own roofline silent, not this."""
import flops
import peaks


def read(run):
    times = [t for r in run.requests for t in r["iteration_times"]]
    if not times or sum(times) <= 0:
        return None
    datarank = int(run.cell.options.get("datarank", 0))
    ops = flops.iteration(run.base, datarank)["total"] * len(times)
    return 100.0 * ops / sum(times) / peaks.F64_FLOPS
