"""Runs on the card (marker ``cuda``; each test decides whether a card is
there and skips without one). On the card:

    python -m pytest --noconftest sdpbench/tests/test_sdpbench_card.py
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

import sdpbench_cells as sc


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(cwd, trace=0):
    return subprocess.run([sys.executable, "sdpbench/run.py", "--workload", "tru9.solve",
                           "--seed", str(2**33 + 3), "--seconds", "3", "--trace", str(trace)],
                          capture_output=True, text=True, timeout=900, cwd=cwd)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_prints_its_result(trace):
    _need_card()
    p = _run(sc.ROOT, trace)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks" and out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    want = {"solve_s", "solve_s_p95", "setup_s"} if not trace else {
        "build_ms", "ipm_iters", "iter_ms", "step_mfu", "jacobi_roofline", "idle_share"}
    assert set(out["metrics"]) == want
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"] and len(out["breakdown"]["idle_gaps"]) <= 10
        assert 0 < out["metrics"]["jacobi_roofline"]["value"] < 100


@pytest.mark.cuda
def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's own files."""
    _need_card()
    shutil.copy(os.path.join(sc.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(sc.SDPBENCH, tmp_path / "sdpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert "{" not in p.stdout
