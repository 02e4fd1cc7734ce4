"""The trace's reduction on synthetic events (CPU): busy time is the union
of the device intervals inside the window, the kernels are summed by
name, and the idle time is named by the host's span and innermost
operation, cut where a span ends."""
import pytest

import sdpbench_cells  # noqa: F401
import trace as T

CPU, CUDA = "cpu", "cuda"


class Ev:
    def __init__(self, name, dev, start, dur, tid=1):
        self._n, self._d, self._s, self._u, self._t = name, dev, start, dur, tid

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def start_thread_id(self):
        return self._t


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": lambda self_: events})()})()


def test_reduce_busy_kernels_and_gaps():
    ev = [
        Ev("sdpbench.window", CPU, 0, 1000),
        Ev("sdpbench.build", CPU, 0, 300),
        Ev("aten::copy_", CPU, 50, 100),
        Ev("sdpbench.solve", CPU, 300, 700),
        Ev("aten::linalg_cholesky_ex", CPU, 400, 50),
        Ev("aten::item", CPU, 690, 110),
        Ev("other thread op", CPU, 0, 1000, tid=2),
        Ev("sdpbench.solve", CUDA, 300, 700),  # the span's GPU-side copy: not work
        Ev("void (anonymous namespace)::cluster_kernel<true>(float*)", CUDA, 100, 100),
        Ev("void (anonymous namespace)::cluster_kernel<true>(float*)", CUDA, 150, 100),
        Ev("Memcpy HtoD (Pageable -> Device)", CUDA, 500, 200),
        Ev("late kernel", CUDA, 950, 100),  # cut at the window's end
    ]
    out = T.reduce(Prof(ev), CUDA)
    assert out["window_s"] == pytest.approx(1e-6)
    # union: [100, 250] + [500, 700] + [950, 1000] = 150 + 200 + 50
    assert out["busy_s"] == pytest.approx(400e-9)
    assert out["kernels"]["void (anonymous namespace)::cluster_kernel<true>(float*)"] == (
        pytest.approx(200e-9), 2)
    assert out["device_ops"][0] == ["(anonymous namespace)::cluster_kernel<true>",
                                    pytest.approx(200e-9)]
    # gaps [0, 100) and [250, 300) in the build span with no operation open
    # (aten::copy_ ended at 150), [300, 500) in the solve span, [700, 950)
    # inside aten::item
    assert dict(out["idle_gaps"]) == {"build: python": pytest.approx(150e-9),
                                      "solve: python": pytest.approx(200e-9),
                                      "solve: aten::item": pytest.approx(250e-9)}
