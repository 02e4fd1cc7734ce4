"""idle_share (%, device trace; the device): one minus the device's busy
time (the union of its activities) over the traced window, whole solves
and the builds between them included."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
