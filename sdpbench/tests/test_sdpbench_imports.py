"""No module of JAX or of the JAX package in a run, compared by whole
top-level name; and no result without a card (CPU)."""
import json
import os
import subprocess
import sys

import sdpbench_cells as sc
import harness


def test_forbidden_modules_compares_whole_top_level_names():
    ok = ["loraine_tpu_torch", "loraine_tpu_torch.ops.jacobi", "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(ok) == []
    bad = ok + ["loraine_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]
    assert harness.forbidden_modules(bad) == ["flax", "jax", "jaxlib", "loraine_tpu"]


def test_a_run_loads_nothing_forbidden():
    """The harness, every metric reader and a CPU run of the timed path, in
    a fresh process."""
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "import harness, time\n"
        "import sdpbench_cells as sc\n"
        "bench = json.load(open(%r))\n"
        "out = harness.run_cell(sc.cell(), 5, 0.5, False, 'cpu', time.perf_counter(), bench,"
        " log=lambda s: None, max_requests=1)\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    harness.read_metric(m['name'], out['_run'])\n"
        "print(json.dumps([out['correct'], harness.forbidden_modules()]))\n"
    ) % (sc.SDPBENCH, sc.HERE, os.path.join(sc.ROOT, "BENCHMARK.json"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env=env, cwd=sc.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [True, []]


def test_run_fails_without_a_card():
    """No fallback to the CPU: exit 3 and no result line."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "sdpbench/run.py", "--workload", "tru9.solve",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, env=env, cwd=sc.ROOT)
    assert p.returncode == 3, (p.returncode, p.stderr[-2000:])
    assert "{" not in p.stdout
