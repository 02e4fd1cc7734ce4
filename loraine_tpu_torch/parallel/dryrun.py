"""The seven mesh gates of `__graft_entry__.py:dryrun_multichip`, on the
port: real problems solved on a ('blocks', 'schur') mesh of ranks, each
held against the same problem solved on one rank.

  1. SDPLIB tru3 (two LMI blocks + LP cone), kit=0, eDIMACS 1e-6: sharded
     == single to 1e-8 relative, and the SDPLIB value 0.0625018 +- 1e-5.
  2. a multi-block SDP on the CG path (kit=1, H_alpha): 1e-7.
  3. rank-1 data (datarank=-1): 1e-7.
  4. sparse storage: 1e-7.
  5. a dense n = 160 problem on the (1, N) mesh: H's rows sharded through
     assembly and the distributed Cholesky / tri_inv over two panels: 1e-7.
  6. one step of a maxcut relaxation at n = 512 on the (1, N) mesh (four
     panels): obj, dimacs, alpha_min and beta_min to 1e-8 relative.
  7. sparse blocks + LP cone with the f32 Schur assembly and its handover
     on the mesh, against the exact single-rank solve: 1e-6.

The problems are built with numpy from the JAX gates' seeds, in their
order; the mesh is (2, N/2) for an even N (else (1, N)), and (1, N) for
gates 5 and 6. ``--modes auto`` (the default) runs the port's own choice,
B1 and B2 on a card; ``--modes cpu`` the JAX CPU run's eigen modes
(eigh_backend 'mixed', step_eig 'exact'), which are quicker on the CPU.

Launcher, one process per rank (a FileStore rendezvous, no port)::

    python -m loraine_tpu_torch.parallel.dryrun --nproc 4 --device cpu --backend gloo
    python -m loraine_tpu_torch.parallel.dryrun --nproc 2 --device cuda --backend gloo
    python -m loraine_tpu_torch.parallel.dryrun --nproc 2 --device cuda --case sdplib:maxG11

It prints one line per gate with the sharded and single-rank values, the
iterations and each rank's B1/B2/B3 launches in the sharded run, and exits
non-zero when a gate or a rank fails. ``--case sdplib:NAME`` solves
tests/data/NAME.dat-s on the (1, N) mesh with ``--opts`` (``--step``: one
step, held against one rank's), and ``--case two_process`` is the
counterpart of tests/multiprocess_worker.py (mesh (N, 1)).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from . import distributed

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(_ROOT, "tests", "data")

# gate -> relative tolerance of sharded against single (the JAX gates')
TOLS = {1: 1e-8, 2: 1e-7, 3: 1e-7, 4: 1e-7, 5: 1e-7, 6: 1e-8, 7: 1e-6}
TRU3_ANCHOR, TRU3_TOL = 0.0625018, 1e-5
CPU_MODES = {"eigh_backend": "mixed", "step_eig": "exact"}


def gate_data(blocks_ax: int) -> Dict[int, dict]:
    """numpy inputs of gates 2-7 (`problem_from_dense` keyword arguments,
    plus 'W' for the maxcut of gate 6), drawn from the JAX gates' seeds in
    their order."""
    rng = np.random.default_rng(0)
    out = {}
    nb, n, m = 2 * blocks_ax, 16, 8
    As, Cs = [], []
    for _ in range(nb):
        A = rng.standard_normal((n, m, m))
        As.append((A + A.transpose(0, 2, 1)) / 2)
        C = rng.standard_normal((m, m))
        Cs.append(C @ C.T + m * np.eye(m))
    out[2] = dict(As=As, Cs=Cs, b=rng.standard_normal(n), pad_multiple=8)

    nb3, n3, m3 = 2 * blocks_ax, 24, 16
    As3, Cs3 = [], []
    b3 = np.zeros(n3)
    for _ in range(nb3):
        V = rng.standard_normal((n3, m3))
        As3.append(np.einsum("jp,jq->jpq", V, V))
        C = rng.standard_normal((m3, m3))
        Cs3.append(C @ C.T + m3 * np.eye(m3))
        b3 += np.einsum("jpp->j", As3[-1])
    out[3] = dict(As=As3, Cs=Cs3, b=b3, datarank=-1, pad_multiple=8)

    nb4, n4, m4 = 2 * blocks_ax, 32, 16
    As4, Cs4 = [], []
    for _ in range(nb4):
        A = np.zeros((n4, m4, m4))
        for j in range(n4):
            r, c = rng.integers(0, m4, 2)
            v = rng.standard_normal()
            A[j, r, c] += v
            A[j, c, r] += v
            d = rng.integers(0, m4)
            A[j, d, d] += 1.0
        As4.append(A)
        Cs4.append(np.eye(m4) * m4)
    b4 = sum(np.einsum("jpp->j", A) for A in As4)
    out[4] = dict(As=As4, Cs=Cs4, b=b4, storage="sparse", pad_multiple=8)

    n5, m5 = 160, 20
    A5 = rng.standard_normal((n5, m5, m5))
    A5 = (A5 + A5.transpose(0, 2, 1)) / 2
    C5 = rng.standard_normal((m5, m5))
    C5 = C5 @ C5.T + m5 * np.eye(m5)
    out[5] = dict(As=[A5], Cs=[C5], b=np.einsum("jpp->j", A5), storage="dense")

    n6 = 512
    rng6 = np.random.default_rng(11)
    W6 = np.zeros((n6, n6))
    for _ in range(3 * n6):
        i, j = rng6.integers(0, n6, 2)
        if i != j:
            w = 1.0 + rng6.random()
            W6[i, j] += w
            W6[j, i] += w
    out[6] = dict(W=W6)

    nlin7 = 12
    C_lin7 = rng.standard_normal((n4, nlin7))
    d_lin7 = np.abs(rng.standard_normal(nlin7)) + 1.0
    out[7] = dict(As=As4, Cs=Cs4, b=b4, C_lin=C_lin7, d_lin=d_lin7, storage="sparse",
                  pad_multiple=8)
    return out


GATE_OPTS = {
    1: {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0},
    2: {"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-6, "verb": 0},
    3: {"kit": 0, "eDIMACS": 1e-6, "datarank": -1, "verb": 0},
    4: {"kit": 0, "eDIMACS": 1e-6, "verb": 0},
    5: {"kit": 0, "eDIMACS": 1e-6, "verb": 0},
    6: {"kit": 0, "verb": 0},
    7: {"kit": 0, "eDIMACS": 1e-6, "verb": 0},
}


def _launches() -> List[int]:
    """This process's B1, B2 and B3 launches so far."""
    from ..ops.jacobi import jacobi_bounds_cuda, jacobi_eigh_cuda
    from ..ops.pcg import cg_minres_f64_cuda

    return [sum(jacobi_eigh_cuda.launches_by_mp.values()),
            sum(jacobi_bounds_cuda.launches_by_mp.values()), cg_minres_f64_cuda.launches]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


def _problem(gate: int, data: dict, device):
    import loraine_tpu_torch as ltt
    from ..models.maxcut import maxcut_problem

    if gate == 1:
        return ltt.problem_from_sdpa(os.path.join(DATA, "tru3.dat-s"), device=device)
    if gate == 6:
        return maxcut_problem(data["W"], datarank=-1, device=device)
    kw = {k: v for k, v in data.items() if k not in ("As", "Cs", "b")}
    return ltt.problem_from_dense(data["As"], data["Cs"], data["b"], device=device, **kw)


def run_gate(gate: int, data: dict, modes: dict, device) -> dict:
    """Gate ``gate`` on this rank: the single-rank and the sharded run, the
    checks, and the record printed for it. Every rank runs it."""
    import loraine_tpu_torch as ltt
    from ..ipm.initial import initial_point
    from ..ipm.step import step
    from .mesh import make_mesh, shard_problem, shard_state

    nproc = distributed.world_size()
    blocks_ax = 2 if nproc % 2 == 0 else 1
    shape = (1, nproc) if gate in (5, 6) else (blocks_ax, nproc // blocks_ax)
    mesh = make_mesh(shape)
    p = _problem(gate, data, device)
    if gate == 3:
        assert any(g.is_rank1 for g in p.groups), "rank-1 compression did not engage"
    if gate in (4, 7):
        assert any(g.is_sparse for g in p.groups), "sparse storage did not engage"
    opts = {**GATE_OPTS[gate], **modes}
    rec = {"gate": gate, "mesh": list(shape), "tol": TOLS[gate]}
    if gate == 6:
        o = ltt.Options(**opts).validated()
        st = initial_point(p, o)
        _, ref = step(p, st, o)
        before = _launches()
        t0 = time.perf_counter()
        _, sh = step(shard_problem(p, mesh), shard_state(st, p, mesh), o)
        ref, sh = ref.to_host(), sh.to_host(mesh)
        rec["seconds"] = time.perf_counter() - t0
        assert sh["h_ok"] and sh["nt_ok"], "maxG step reported failure"
        rec.update(single=ref["obj"], sharded=sh["obj"], iters=[1, 1],
                   stats={f: sh[f] for f in ("obj", "dimacs", "alpha_min", "beta_min")})
        for f in ("obj", "dimacs", "alpha_min", "beta_min"):
            assert _rel(sh[f], ref[f]) <= TOLS[6], f"gate 6 {f}: sharded {sh[f]!r} != {ref[f]!r}"
    else:
        ref = ltt.solve(p, dict(opts), device=device)
        sp = shard_problem(p, mesh)
        before = _launches()
        t0 = time.perf_counter()
        sharded_opts = {**opts, "assembly_precision": "f32"} if gate == 7 else opts
        res = ltt.solve(sp, dict(sharded_opts), device=device)
        rec["seconds"] = time.perf_counter() - t0
        rec.update(single=ref.objective, sharded=res.objective,
                   iters=[ref.iterations, res.iterations])
        assert ref.status == 1, f"gate {gate}: single-rank status {ref.status_name}"
        assert res.status == 1, f"gate {gate}: sharded status {res.status_name}"
        assert _rel(res.objective, ref.objective) <= TOLS[gate], (
            f"gate {gate}: sharded {res.objective!r} != single {ref.objective!r}")
        if gate == 1:
            assert abs(res.objective - TRU3_ANCHOR) < TRU3_TOL, (
                f"tru3 objective {res.objective!r} off the SDPLIB value")
        if gate == 7:
            rec["mixed_handover"] = res.mixed_handover
    rec["rel"] = _rel(rec["sharded"], rec["single"])
    rec["launches"] = [a - b for a, b in zip(_launches(), before)]
    return rec


def run_sdplib(name: str, opts: dict, device, one_step: bool) -> dict:
    """SDPLIB ``name`` solved with ``opts`` on the (1, N) mesh (the caller
    holds the objective against its own single-device run); ``one_step``:
    one step beside one rank's, obj/dimacs/alpha/beta to 1e-8 relative."""
    import loraine_tpu_torch as ltt
    from ..ipm.initial import initial_point
    from ..ipm.step import step
    from .mesh import make_mesh, shard_problem, shard_state

    o = ltt.Options(**opts).validated()
    p = ltt.load_problem(os.path.join(DATA, f"{name}.dat-s"), o, device=device)
    mesh = make_mesh((1, distributed.world_size()))
    rec = {"case": f"sdplib:{name}" + (" step" if one_step else ""),
           "mesh": [1, mesh.size], "n": p.n}
    sp = shard_problem(p, mesh)
    if one_step:
        st = initial_point(p, o)
        _, ref = step(p, st, o)
        ref = ref.to_host()
        before = _launches()
        t0 = time.perf_counter()
        _, sh = step(sp, shard_state(st, p, mesh), o)
        sh = sh.to_host(mesh)
        rec["seconds"] = time.perf_counter() - t0
        for f in ("obj", "dimacs", "alpha_min", "beta_min"):
            assert _rel(sh[f], ref[f]) <= 1e-8, f"{name} step {f}: {sh[f]!r} != {ref[f]!r}"
        rec.update(single=ref["obj"], sharded=sh["obj"], iters=[1], status=int(sh["h_ok"]))
    else:
        before = _launches()
        t0 = time.perf_counter()
        res = ltt.solve(sp, dict(opts), device=device)
        rec["seconds"] = time.perf_counter() - t0
        rec.update(sharded=res.objective, iters=[res.iterations], status=res.status,
                   median_iter_s=float(np.median(res.iteration_times)))
    rec["launches"] = [a - b for a, b in zip(_launches(), before)]
    return rec


def run_two_process(device) -> dict:
    """tests/multiprocess_worker.py on the port: the same problem on every
    rank, mesh (N, 1) (blocks across ranks), solved to eDIMACS 1e-7."""
    import loraine_tpu_torch as ltt
    from .mesh import make_mesh, shard_problem

    rng = np.random.default_rng(0)
    nb, n, m = 2, 12, 8
    As, Cs = [], []
    for _ in range(nb):
        A = rng.standard_normal((n, m, m))
        As.append((A + A.transpose(0, 2, 1)) / 2)
        C = rng.standard_normal((m, m))
        Cs.append(C @ C.T + m * np.eye(m))
    b = rng.standard_normal(n)
    problem = ltt.problem_from_dense(As, Cs, b, device=device)
    mesh = make_mesh((distributed.world_size(), 1))
    before = _launches()
    res = ltt.solve(shard_problem(problem, mesh), {"kit": 0, "eDIMACS": 1e-7, "verb": 0},
                    device=device)
    return {"case": "two_process", "mesh": [mesh.size, 1], "status": res.status,
            "sharded": res.objective, "iters": [res.iterations],
            "launches": [a - b for a, b in zip(_launches(), before)]}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check_collectives(device) -> str:
    """The two collectives the mesh uses, on this rank's device: an
    all_reduce (sum, min, max) and a broadcast from rank 0, each checked
    against the value it must give. Returns the line to print."""
    import torch.distributed as dist

    r, n = distributed.rank(), distributed.world_size()
    x = torch.full((3,), float(r + 1), dtype=torch.float64, device=device)
    dist.all_reduce(x)
    lo = torch.tensor([r], dtype=torch.int64, device=device)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    y = torch.arange(4, dtype=torch.float64, device=device) * (r + 1)
    dist.broadcast(y, src=0)
    assert x.tolist() == [n * (n + 1) / 2] * 3 and lo.item() == 0, (x, lo)
    assert y.tolist() == [0.0, 1.0, 2.0, 3.0], y
    return (f"COLLECTIVES rank={r} all_reduce=ok broadcast=ok device={x.device} "
            f"backend={dist.get_backend()}")


def _rank_main(a) -> None:
    distributed.initialize(a.init, a.nproc, a.rank, backend=a.backend, device=a.device)
    device = distributed.device()
    print(check_collectives(device), flush=True)
    modes = CPU_MODES if a.modes == "cpu" else {}
    if a.case == "gates":
        data = gate_data(2 if a.nproc % 2 == 0 else 1)
        for gate in a.gates:
            rec = run_gate(gate, data.get(gate, {}), modes, device)
            print("RECORD " + json.dumps({"rank": a.rank, **rec}), flush=True)
    elif a.case == "two_process":
        rec = run_two_process(device)
        print("RECORD " + json.dumps({"rank": a.rank, **rec}), flush=True)
    else:
        opts = {"kit": 0, "eDIMACS": 1e-7, "initpoint": 1, "verb": 0, **json.loads(a.opts),
                **modes}
        rec = run_sdplib(a.case.split(":", 1)[1], opts, device, a.step)
        print("RECORD " + json.dumps({"rank": a.rank, **rec}), flush=True)
    distributed.shutdown()


def records(outs: List[str]) -> List[dict]:
    """The RECORD lines of every rank's output, in order."""
    return [json.loads(line[7:]) for out in outs for line in out.splitlines()
            if line.startswith("RECORD ")]


def summarize(recs: List[dict]) -> List[str]:
    """One line per gate or case: rank 0's values and every rank's B1, B2
    and B3 launches."""
    lines = []
    keys = sorted({(r.get("gate"), r.get("case")) for r in recs}, key=str)
    for gate, case in keys:
        rs = sorted((r for r in recs if r.get("gate") == gate and r.get("case") == case),
                    key=lambda r: r["rank"])
        r0 = rs[0]
        name = f"gate {gate}" if gate is not None else case
        single = f" single {r0['single']!r}" if "single" in r0 else ""
        rel = f" rel {r0['rel']:.2e}" if "rel" in r0 else ""
        tol = f" (tol {r0['tol']:g})" if "tol" in r0 else ""
        lines.append(
            f"{name} mesh {tuple(r0['mesh'])}: sharded {r0['sharded']!r}{single}{rel}{tol} "
            f"iterations {r0['iters']} B1/B2/B3 launches per rank "
            f"{[tuple(r['launches']) for r in rs]}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    ap.add_argument("--modes", choices=("auto", "cpu"), default="auto")
    ap.add_argument("--gates", default="1,2,3,4,5,6,7")
    ap.add_argument("--case", default="gates",
                    help="'gates', 'two_process' or 'sdplib:NAME'")
    ap.add_argument("--step", action="store_true", help="sdplib: one step only")
    ap.add_argument("--opts", default="{}", help="sdplib: solver options (JSON) over "
                    "kit=0, eDIMACS 1e-7, initpoint 1")
    ap.add_argument("--timeout", type=float, default=1200.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init", default=None)
    a = ap.parse_args(argv)
    a.gates = [int(g) for g in a.gates.split(",") if g]
    if a.rank is not None:
        _rank_main(a)
        return 0
    cmd = ["-m", "loraine_tpu_torch.parallel.dryrun", "--device", a.device,
           "--modes", a.modes, "--gates", ",".join(map(str, a.gates)), "--case", a.case]
    if a.backend:
        cmd += ["--backend", a.backend]
    if a.step:
        cmd.append("--step")
    if a.opts != "{}":
        cmd += ["--opts", a.opts]
    t0 = time.perf_counter()
    outs = distributed.launch(cmd, a.nproc, a.timeout, env={"PYTHONPATH": _ROOT})
    recs = records(outs)
    for line in (ln for out in outs for ln in out.splitlines() if ln.startswith("COLLECTIVES")):
        print(line)
    for line in summarize(recs):
        print(line)
    print(f"dryrun OK: {a.nproc} ranks, device {a.device}, backend "
          f"{a.backend or ('nccl' if a.device == 'cuda' else 'gloo')}, "
          f"{time.perf_counter() - t0:.1f} s")
    print("RECORDS " + json.dumps(recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
