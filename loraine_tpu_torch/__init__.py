"""loraine_tpu_torch: the PyTorch / CUDA port of loraine_tpu.

A primal-dual predictor-corrector interior-point solver for linear SDPs,
ported from the JAX package `loraine_tpu` (which stays the reference) to
PyTorch, with its Pallas TPU kernels rewritten as CUDA kernels for Hopper.

The port runs the direct (kit=0) and the CG (kit=1) paths on dense, rank-1
and sparse COO data with the LP cone, at precision 'f64' and in the
double-double tiers 'dd' and 'dd2' (`ops/dd.py`, `ops/ozaki.py`), and the
JAX package's front-ends and extras: the POEMA-JSON, MAT and raw-dict
entries (`io/poema.py`, `problem_from_dict`, `solve_json`), the modeling
layer (`modeling`, `models`), ADMM (`solve_admm`), checkpoints
(`save_state`, `load_state`), the per-phase table (``timing=2``,
`utils/diagnostics.py`), ``profile_dir`` (a `torch.profiler` trace) and the
CLI (``python -m loraine_tpu_torch``). Its
kernels are the two Jacobi kernels of `ops/jacobi.py`
(CUDA C++ in `csrc/jacobi.cu`) and the two single-launch CG kernels of
`ops/pcg.py` (`csrc/pcg.cu`), built with nvcc at first use. The device is
explicit and defaults to ``"cuda"``; pass ``device="cpu"`` to run the
kernels' plain PyTorch versions on the CPU::

    import loraine_tpu_torch as ltt
    res = ltt.solve_sdpa("tests/data/theta1.dat-s",
                         {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1})
    print(res.status_name, res.objective)

Every entry point takes ``device=`` the same way: ``ltt.solve_json(path,
opts, device="cpu")``, ``ltt.modeling.Model().solve(opts, device="cpu")``,
``ltt.load_state(path, device="cpu")``.

`parallel/` runs the solve on a ('blocks', 'schur') mesh of ranks, one
process each, over torch.distributed: ``distributed.initialize()``
(backend 'nccl' across cards, 'gloo' for CPU ranks or ranks sharing one
card), ``make_mesh``/``auto_mesh``, ``shard_problem``, then ``solve`` on
every rank. ``python -m loraine_tpu_torch.parallel.dryrun --nproc 4
--device cpu`` runs the mesh gates on Gloo CPU ranks. Every option value
runs on a mesh too, the precision tiers and ``nt_precision='dd'``
included.
"""
from . import modeling
from .config import DEFAULT_OPTIONS, Options
from .io.poema import read_mat_dict, read_poema_json, write_poema_json
from .io.sdpa import SDPAData, read_sdpa, write_sdpa
from .ipm.admm import ADMMResult, solve_admm
from .ipm.solver import Result, Solver, load_problem, solve, solve_json, solve_sdpa
from .ipm.state import IPMState
from .problem import (BlockGroup, SDPProblem, problem_from_dense, problem_from_dict,
                      problem_from_sdpa)
from .utils.checkpoint import load_state, save_state

__version__ = "0.1.0"

__all__ = [
    "modeling",
    "Options",
    "DEFAULT_OPTIONS",
    "SDPAData",
    "read_sdpa",
    "write_sdpa",
    "BlockGroup",
    "SDPProblem",
    "problem_from_dense",
    "problem_from_dict",
    "problem_from_sdpa",
    "read_poema_json",
    "write_poema_json",
    "read_mat_dict",
    "Result",
    "Solver",
    "solve",
    "solve_sdpa",
    "load_problem",
    "solve_json",
    "solve_admm",
    "ADMMResult",
    "IPMState",
    "save_state",
    "load_state",
]
