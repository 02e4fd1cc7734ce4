"""The span reduction on synthetic events (CPU): device time, launches and
host waits charged to every ``ltt.`` span open at the runtime call behind
each device activity, the step's idle share, the device time in no span,
the idle gaps named by the program's span, and `trace.reduce`'s numbers
unmoved by the program's spans."""
import pytest

import sdpbench_cells  # noqa: F401
import spans as SP
import trace as T

CPU, CUDA = "cpu", "cuda"


class Ev:
    def __init__(self, name, dev, start, dur, tid=1, corr=0):
        self._n, self._d, self._s, self._u, self._t = name, dev, start, dur, tid
        self._c = corr  # CUPTI's: a device activity's equals its runtime call's

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

    def correlation_id(self):
        return self._c


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": lambda self_: events})()})()


def launch(t, corr, dur=2):
    return Ev("cudaLaunchKernel", CPU, t, dur, corr=corr)


def kernel(name, t, dur, corr):
    return Ev(name, CUDA, t, dur, corr=corr)


def window():
    """One solve of one step in a 1000 ns window: build, init, a step with
    an eigen-call inside its NT scaling, the stats' copy to the host and
    its sync, a factor span, and a kernel launched outside any span."""
    return [
        Ev("sdpbench.window", CPU, 0, 1000),
        Ev("sdpbench.build", CPU, 0, 100),
        Ev("ltt.build", CPU, 10, 80),
        Ev("cudaMemcpyAsync", CPU, 20, 5, corr=1),
        Ev("Memcpy HtoD (Pageable -> Device)", CUDA, 30, 10, corr=1),
        Ev("sdpbench.solve", CPU, 100, 900),
        Ev("ltt.solve", CPU, 110, 780),
        Ev("ltt.step", CPU, 200, 600),
        Ev("ltt.nt", CPU, 210, 200),
        Ev("aten::mm", CPU, 215, 10),
        launch(218, 2),
        kernel("gemm", 220, 50, 2),
        Ev("ltt.eig", CPU, 300, 100),
        launch(310, 3),
        kernel("sm_kernel<false>", 320, 60, 3),
        launch(330, 4),
        kernel("cluster_kernel<true>", 390, 30, 4),
        Ev("ltt.factor", CPU, 450, 150),
        launch(460, 5),
        kernel("potrf", 470, 100, 5),
        Ev("aten::linalg_cholesky_ex", CPU, 480, 110),
        Ev("cudaMemcpyAsync", CPU, 500, 75, corr=6),
        Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 570, 4, corr=6),
        Ev("cudaStreamSynchronize", CPU, 576, 3, corr=7),
        Ev("ltt.stats", CPU, 650, 140),
        Ev("cudaStreamIsCapturing", CPU, 655, 1, corr=8),
        Ev("cudaMemcpyAsync", CPU, 660, 60, corr=9),
        Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 715, 5, corr=9),
        Ev("cudaStreamIsCapturing", CPU, 721, 1, corr=10),
        Ev("cudaStreamSynchronize", CPU, 722, 3, corr=11),
        Ev("cudaDeviceSynchronize", CPU, 730, 40, corr=12),
        launch(900, 13),
        kernel("stray", 905, 20, 13),
        Ev("other thread op", CPU, 0, 1000, tid=2),
    ]


@pytest.fixture()
def summary():
    return SP.reduce(Prof(window()), CUDA)


def test_device_time_and_launches_by_span_with_nesting(summary):
    sp = summary["spans"]
    ns = 1e-9
    assert sp["ltt.eig"]["device_s"] == pytest.approx(90 * ns)
    assert sp["ltt.eig"]["launches"] == 2
    # the NT span holds its own GEMM and its child's eigen-kernels
    assert sp["ltt.nt"]["device_s"] == pytest.approx(140 * ns)
    assert sp["ltt.nt"]["launches"] == 3
    assert sp["ltt.factor"]["device_s"] == pytest.approx(104 * ns)
    # the step's: the NT scaling's, the factor's, and the stats' copy
    assert sp["ltt.step"]["device_s"] == pytest.approx(249 * ns)
    assert sp["ltt.step"]["launches"] == 4
    assert sp["ltt.solve"]["device_s"] == pytest.approx(249 * ns)
    assert sp["ltt.build"]["device_s"] == pytest.approx(10 * ns)
    assert sp["ltt.build"]["launches"] == 0
    assert {k: v["count"] for k, v in sp.items()} == {
        "ltt.build": 1, "ltt.solve": 1, "ltt.step": 1, "ltt.nt": 1, "ltt.eig": 1,
        "ltt.factor": 1, "ltt.stats": 1}


def test_copy_to_host_and_its_sync_count_as_one_wait(summary):
    sp = summary["spans"]
    # factor: the copy and the sync straight after it, one wait
    assert sp["ltt.factor"]["waits"] == 1
    assert sp["ltt.factor"]["waits_s"] == pytest.approx(78e-9)
    # stats: the copy, its sync behind a query call (one wait), then a
    # device sync of its own
    assert sp["ltt.stats"]["waits"] == 2
    assert sp["ltt.stats"]["waits_s"] == pytest.approx(103e-9)
    assert sp["ltt.step"]["waits"] == 3
    # a copy to the device is no wait
    assert sp["ltt.build"]["waits"] == 0


def test_step_idle_share(summary):
    # ltt.step [200, 800): device busy [220, 270) + [320, 380) + [390, 420)
    # + [470, 574) + [715, 720) = 249 of 600 ns
    assert summary["step_s"] == pytest.approx(600e-9)
    assert summary["step_busy_s"] == pytest.approx(249e-9)
    r = SP.readings(summary, _Base(), 0, 1)
    assert r["step_idle_share"] == pytest.approx(100.0 * (1 - 249 / 600))
    assert r["host_waits_per_iter"] == 3
    assert r["launches_per_iter"] == 4


def test_unattributed_and_linked_device_time(summary):
    # the stray kernel was launched in no ltt. span
    assert summary["unattributed_s"] == pytest.approx(20e-9)
    assert summary["device_s"] == pytest.approx(279e-9)
    assert summary["linked_s"] == pytest.approx(279e-9)
    line = SP.per_iteration_line(summary)
    assert "over 1 steps: solve 0.000, step 0.000, nt 0.000" in line
    assert "linked to a runtime call 100.00%" in line
    assert f"ltt. span {100 * (1 - 20 / 279):.2f}%" in line


def test_unlinked_device_time_counts_as_unattributed():
    ev = window() + [Ev("orphan", CUDA, 950, 10, corr=99)]
    s = SP.reduce(Prof(ev), CUDA)
    assert s["linked_s"] == pytest.approx(279e-9)
    assert s["unattributed_s"] == pytest.approx(30e-9)


def test_idle_gaps_named_by_the_program_span(summary):
    # the device's gaps cut at every span edge, each piece named by the
    # benchmark span, the innermost ltt. span and the innermost host range
    # open at its start: 721 ns idle in all
    ns = 1e-9
    assert dict(summary["idle_gaps"]) == pytest.approx({
        "build: python": 20 * ns,
        "build/ltt.build: python": 70 * ns,
        "solve: python": 100 * ns,
        "solve/ltt.solve: python": 180 * ns,
        "solve/ltt.step: python": 100 * ns,
        "solve/ltt.nt: python": 40 * ns,
        "solve/ltt.eig: python": 30 * ns,
        "solve/ltt.factor: python": 20 * ns,
        "solve/ltt.factor: cudaMemcpyAsync": 26 * ns,
        "solve/ltt.stats: python": 135 * ns,
    })


def test_readings_rooflines_by_operation(summary):
    base = _Base()
    r = SP.readings(summary, base, 0, 1)
    import flops
    import peaks

    it = flops.iteration(base, 0)
    jac = flops.jacobi(base)
    eig = max(jac["flops"] / peaks.F32_FLOPS, jac["bytes"] / peaks.HBM_BYTES)
    assert r["eig_roofline"] == pytest.approx(100 * eig / 90e-9)
    assert r["factor_roofline"] == pytest.approx(100 * it["factorization"] / peaks.F64_FLOPS / 104e-9)
    assert r["assembly_roofline"] is None  # no ltt.schur in this window


def test_trace_reduce_unmoved_by_program_spans():
    plain = [e for e in window() if not e.name().startswith("ltt.")]
    a = T.reduce(Prof(plain), CUDA)
    b = T.reduce(Prof(window()), CUDA)
    assert (a["busy_s"], a["window_s"], a["kernels"]) == (b["busy_s"], b["window_s"], b["kernels"])


class _Base:
    """tru3's sizes: one 13-block and 72 LP variables over 36 constraints
    (counts only; `flops` reads the shapes)."""

    def __init__(self):
        import numpy as np

        self.nvar = 36
        self.block_sizes = [13, -72]
        z = np.zeros(0, dtype=np.int64)
        self.blocks = [(np.arange(1, 37), z, z, z), (np.arange(1, 37), np.arange(36), z, z)]
