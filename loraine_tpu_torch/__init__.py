"""loraine_tpu_torch: the PyTorch / CUDA port of loraine_tpu.

A primal-dual predictor-corrector interior-point solver for linear SDPs,
ported from the JAX package `loraine_tpu` (which stays the reference) to
PyTorch, with its Pallas TPU kernels rewritten as CUDA kernels for Hopper.

The port runs the direct (kit=0) and the CG (kit=1) f64 paths on dense and
rank-1 data. Its kernels are the two Jacobi kernels of `ops/jacobi.py`
(CUDA C++ in `csrc/jacobi.cu`) and the two single-launch CG kernels of
`ops/pcg.py` (`csrc/pcg.cu`), built with nvcc at first use. The device is
explicit and defaults to ``"cuda"``; pass ``device="cpu"`` to run the
kernels' plain PyTorch versions on the CPU::

    import loraine_tpu_torch as ltt
    res = ltt.solve_sdpa("tests/data/theta1.dat-s",
                         {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1})
    print(res.status_name, res.objective)
"""
from .config import Options
from .io.sdpa import SDPAData, read_sdpa, write_sdpa
from .ipm.solver import Result, Solver, load_problem, solve, solve_sdpa
from .ipm.state import IPMState
from .problem import BlockGroup, SDPProblem, problem_from_dense, problem_from_sdpa

__version__ = "0.1.0"

__all__ = [
    "Options",
    "SDPAData",
    "read_sdpa",
    "write_sdpa",
    "BlockGroup",
    "SDPProblem",
    "problem_from_dense",
    "problem_from_sdpa",
    "IPMState",
    "Result",
    "Solver",
    "solve",
    "solve_sdpa",
    "load_problem",
]
