"""The route of a solve, resolved once (`Options.resolved`, `config.py`):
the values every 'auto' stands for in the benchmark's four cells
(sdpbench/workloads/), on a card and on the CPU, and the f32 Schur
assembly's 'auto' around n = 512. No card is needed to build the object,
and no test here runs a solve.
"""
import pathlib

import pytest
import torch

import loraine_tpu_torch as ltt
from loraine_tpu_torch.ipm.step import step
from torch_cases import sized_problem

DATA = pathlib.Path(__file__).parent / "data"
# sdpbench/configs/{tru9,maxG11,thetaG11}.json
KIT0 = {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "verb": 0}
CONFIGS = {"tru9": KIT0, "maxG11": dict(KIT0, datarank=-1),
           "thetaG11": dict(KIT0, datarank=-1)}
# sdpbench/workloads/*.json
LIBRARY_EIGH = {"eigh_backend": "mixed", "step_eig": "exact"}
CELLS = {"tru9.solve": ("tru9", {}), "thetaG11.solve": ("thetaG11", {}),
         "maxG11.library-eigh": ("maxG11", LIBRARY_EIGH),
         "tru9.library-eigh": ("tru9", LIBRARY_EIGH)}
FIELDS = ("eigh_backend", "step_eig", "chol_backend", "nt_precision", "assembly_precision",
          "cg_kernel", "cg_materialize")
# the route each cell runs today, in FIELDS' order, on a card and on the CPU
ROUTES = {
    "tru9.solve": {"cuda": ("pallas", "pallas", "f64", "f64", "f64", "xla", "never"),
                   "cpu": ("pallas", "pallas", "f64", "f64", "f64", "xla", "never")},
    "thetaG11.solve": {"cuda": ("pallas", "pallas", "f64", "f64", "f64", "xla", "never"),
                       "cpu": ("pallas", "pallas", "f64", "f64", "f64", "xla", "never")},
    "maxG11.library-eigh": {"cuda": ("mixed", "exact", "f64", "f64", "f64", "ff", "never"),
                            "cpu": ("mixed", "exact", "f64", "f64", "f64", "xla", "never")},
    "tru9.library-eigh": {"cuda": ("mixed", "exact", "f64", "f64", "f64", "xla", "never"),
                          "cpu": ("mixed", "exact", "f64", "f64", "f64", "xla", "never")},
}


@pytest.fixture(scope="module")
def problems():
    return {name: ltt.load_problem(str(DATA / f"{name}.dat-s"), opts, device="cpu")
            for name, opts in CONFIGS.items()}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_route(problems, cell, device):
    config, extra = CELLS[cell]
    opts = ltt.Options.from_dict(dict(CONFIGS[config], **extra)).validated()
    r = opts.resolved(problems[config], torch.device(device))
    assert tuple(getattr(r, f) for f in FIELDS) == ROUTES[cell][device]
    assert opts.eigh_backend == extra.get("eigh_backend", "auto")  # the user's values stay


def test_solver_route_keeps_user_options(problems):
    """`Solver` resolves once: ``route`` is what the steps read, ``opts``
    what the user gave (the header, the result, checkpoints)."""
    s = ltt.Solver(problems["thetaG11"], CONFIGS["thetaG11"], device="cpu")
    assert (s.opts.eigh_backend, s.opts.step_eig, s.opts.nt_precision) == ("auto",) * 3
    assert tuple(getattr(s.route, f) for f in FIELDS) == ROUTES["thetaG11.solve"]["cpu"]
    assert s.route.resolved(s.problem, "cuda") == s.route  # no 'auto' left to change


@pytest.mark.parametrize("n,nlin,rank1,kit,materialize,precision,device,want", [
    (3240, 6480, False, 0, "auto", "f64", "cuda", "f32"),  # tru9: the LP block in f32
    (3240, 6480, False, 0, "auto", "f64", "cpu", "f64"),  # never on the CPU
    (800, 0, True, 0, "auto", "f64", "cuda", "f64"),  # maxG11: rank-1 groups stay exact
    (512, 0, False, 0, "auto", "f64", "cuda", "f32"),
    (511, 0, False, 0, "auto", "f64", "cuda", "f64"),
    (512, 0, False, 1, "auto", "f64", "cuda", "f32"),  # kit=1 materializes H at n <= 512
    (513, 0, False, 1, "auto", "f64", "cuda", "f64"),  # matrix-free: no H to assemble
    (513, 0, False, 1, "always", "f64", "cuda", "f32"),
    (3240, 6480, False, 0, "auto", "dd", "cuda", "f64"),  # never under the tiers
])
def test_f32_assembly_auto(n, nlin, rank1, kit, materialize, precision, device, want):
    o = ltt.Options(kit=kit, assembly_precision="auto", cg_materialize=materialize,
                    precision=precision)
    r = o.resolved(sized_problem(n, nlin, rank1), device)
    assert r.assembly_precision == want
    assert r.cg_materialize == ("always" if materialize == "always" or n <= 512 else "never")


def test_step_refuses_unresolved_options(problems):
    with pytest.raises(ValueError, match="still 'auto'"):
        step(problems["maxG11"], None, ltt.Options())
