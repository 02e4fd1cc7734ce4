"""Each examples/torch_*.py, the loraine_tpu_torch counterparts of the JAX
package's examples, run with ``--device cpu`` in a subprocess: it exits 0
(its own asserts, those of its JAX twin, hold) and imports nothing of JAX
or of the JAX package. Each takes a few seconds on the CPU."""
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ["solve_sdpa", "maxcut", "min_distortion", "modeling_correlation",
            "high_precision_lp"]

# run the script as __main__, then check what it imported
_RUN = (
    "import runpy, sys\n"
    "path = sys.argv[1]\n"
    "sys.argv = [path, '--device', 'cpu']\n"
    "runpy.run_path(path, run_name='__main__')\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'loraine_tpu')]\n"
    "assert not bad, bad\n"
)


def test_every_jax_example_has_a_torch_twin():
    jax_examples = {p.stem for p in (REPO / "examples").glob("*.py")
                    if not p.stem.startswith("torch_")}
    assert jax_examples == set(EXAMPLES)
    assert all((REPO / "examples" / f"torch_{name}.py").exists() for name in EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_torch_example_runs_on_cpu(name):
    path = REPO / "examples" / f"torch_{name}.py"
    out = subprocess.run([sys.executable, "-c", _RUN, str(path)], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
