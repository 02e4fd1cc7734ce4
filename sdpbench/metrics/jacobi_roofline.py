"""jacobi_roofline (%, device trace; kernels: csrc/jacobi.cu B1 and B2):
the least time the card needs for the Jacobi kernels' work in the window
over their device time in the trace. The work is implementation-
independent (`flops.jacobi`: per iteration, the NT scaling's
eigendecomposition with eigenvectors and the two steplengths' four
spectra without them, at the instance's block sizes, at 67
TFLOP/s float32, or their float32 inputs read and outputs written once at
3.35 TB/s, whichever is larger), times the window's iterations. A run in
which no Jacobi kernel ran reads nothing."""
import flops
import harness
import peaks


def read(run):
    t = run.trace
    if not t:
        return None
    device_s = sum(sec for name, (sec, _) in t["kernels"].items()
                   if harness.JACOBI_KERNEL.search(name))
    if device_s <= 0:
        return None
    work = flops.jacobi(run.base)
    per_iter = max(work["flops"] / peaks.F32_FLOPS, work["bytes"] / peaks.HBM_BYTES)
    iters = sum(r["iterations"] for r in run.requests)
    return 100.0 * per_iter * iters / device_s
