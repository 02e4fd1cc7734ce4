"""theta1 on the CG path (kit=1) at precision 'dd2' under the native dd NT
scaling, run in modes that tell the NT kernels' part in its end game from
the rest of the arithmetic of the device it runs on.

Run from the root of a checkout:

    python3 -m loraine_tpu_torch.utils.cg_dd2_probe MODE [MODE ...] [--out FILE.npz]

MODE is one of

  kernels      the card; `nt_scale_dd` with D1-D3 (csrc/dd_linalg.cu)
  plain        the card; the dd routes of `ops/dd_linalg.py` sent to the
               plain versions, run eagerly on the same CUDA tensors
  nt-cpu       the card; every `nt_scale_dd` computed on the CPU from the
               card's iterate (the plain versions) and its outputs moved back
  cpu          the CPU, the whole solve
  cpu-nt-card  the CPU; every `nt_scale_dd` computed on the card (D1-D3)
               from the CPU's iterate and its outputs moved back

each with the options CG_DD2 (tests/test_precision.py's theta1 kit=1
'dd2' case) and nt_precision='dd'. For
each mode it prints one JSON line: the status, the iterations, DIMACS, the
errors, the seconds, the iteration history and, per NT call, dd_ok and the
range of D. With both 'kernels' and 'plain' it also prints whether their
histories and every NT output (D, G, W and their tails, per call) are
equal bit for bit. ``--out`` writes the iterates that the 'kernels' (else
the first) mode scaled (X, S as hi and lo words, per call) and the
scaling's D and W (hi, lo), for another implementation to scale; run
``JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_dd_linalg.py FILE.npz``
to hold the JAX package's `nt_scale_dd` against them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

# theta1 on the CG path at 'dd2' (tests/test_precision.py's options)
CG_DD2 = {"precision": "dd2", "kit": 1, "preconditioner": 1, "eDIMACS": 1e-10,
          "tol_cg_min": 1e-10, "initpoint": 1, "verb": 0, "maxit": 40, "datasparsity": 0}
MODES = ("kernels", "plain", "nt-cpu", "cpu", "cpu-nt-card")


def _moved(t, device):
    """A NamedTuple of the NT scaling with its tensors on ``device``."""
    return type(t)(*(f.to(device) if torch.is_tensor(f) else f for f in t))


@contextlib.contextmanager
def _mode(mode: str, calls: list):
    """Patches the step's `nt_scale_dd` (and for 'plain' the dd routes) for
    ``mode``; appends (X, S, nts, tails) of every call to ``calls``."""
    import loraine_tpu_torch.ipm.step as S
    from ..ops import dd_linalg as dl
    from ..ops.dd import DD

    orig, route = S.nt_scale_dd, dl._route
    to = {"nt-cpu": "cpu", "cpu-nt-card": "cuda"}.get(mode)

    def scaled(X, Sd, **kw):
        if to is None:
            nts, tails = orig(X, Sd, **kw)
        else:
            back = X.hi.device
            mv = lambda d: DD(d.hi.to(to), d.lo.to(to))  # noqa: E731
            nts, tails = orig(mv(X), mv(Sd), **kw)
            nts, tails = _moved(nts, back), _moved(tails, back)
        calls.append((X, Sd, nts, tails))
        return nts, tails

    S.nt_scale_dd = scaled
    if mode == "plain":
        dl._route = lambda x, plain, cuda, *args: plain(*args)
    try:
        yield
    finally:
        S.nt_scale_dd, dl._route = orig, route


def run(mode: str) -> tuple:
    """(record, calls) of one theta1 CG 'dd2' solve under ``mode``."""
    import loraine_tpu_torch as ltt

    device = "cpu" if mode.startswith("cpu") else "cuda"
    calls = []
    with _mode(mode, calls):
        t0 = time.perf_counter()
        r = ltt.solve_sdpa("tests/data/theta1.dat-s", dict(CG_DD2, nt_precision="dd"),
                           device=device)
        secs = time.perf_counter() - t0
    nt = [{"dd_ok": bool(t.dd_ok), "D_min": float(n.D.min()), "D_max": float(n.D.max())}
          for _, _, n, t in calls]
    rec = {"mode": mode, "status": r.status_name, "objective": r.objective,
           "iterations": r.iterations, "cg_iterations": r.cg_iterations, "dimacs": r.dimacs,
           "errs": r.errs, "seconds": secs, "history": r.history, "nt": nt}
    return rec, calls


def _outputs(call) -> list:
    _, _, nts, tails = call
    return [nts.D, nts.G, nts.W, tails.D_lo, tails.G_lo, tails.W_lo]


def same_bits(a: tuple, b: tuple) -> dict:
    """Whether two runs' histories and NT outputs are equal bit for bit."""
    (ra, ca), (rb, cb) = a, b
    # compared as JSON: repr keeps every bit, and NaN equals NaN
    ha, hb = ([json.dumps(h) for h in r["history"]] for r in (ra, rb))
    first = next((i for i, (x, y) in enumerate(zip(ha, hb)) if x != y), None)
    nt_equal = len(ca) == len(cb) and all(
        torch.equal(x.cpu(), y.cpu()) for p, q in zip(ca, cb) for x, y in zip(_outputs(p),
                                                                              _outputs(q)))
    return {"history_equal": ha == hb, "first_history_difference": first,
            "nt_calls": [len(ca), len(cb)], "nt_outputs_equal": nt_equal}


def save(path: str, calls: list) -> None:
    """X, S (hi, lo) and D, W (hi, lo) of every NT call, stacked."""
    def stack(f):
        return np.stack([f(c).detach().cpu().numpy() for c in calls])

    np.savez(path, X_hi=stack(lambda c: c[0].hi), X_lo=stack(lambda c: c[0].lo),
             S_hi=stack(lambda c: c[1].hi), S_lo=stack(lambda c: c[1].lo),
             D_hi=stack(lambda c: c[2].D), D_lo=stack(lambda c: c[3].D_lo),
             W_hi=stack(lambda c: c[2].W), W_lo=stack(lambda c: c[3].W_lo),
             dd_ok=np.array([bool(c[3].dd_ok) for c in calls]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="+", choices=MODES)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if any(m != "cpu" for m in a.modes):
        from .cuda_build import build_libraries

        build_libraries("jacobi", "pcg", "dd_linalg")
    runs = {}
    for mode in a.modes:
        runs[mode] = run(mode)
        print(json.dumps(runs[mode][0]), flush=True)
    if "kernels" in runs and "plain" in runs:
        print(json.dumps({"kernels_vs_plain": same_bits(runs["kernels"], runs["plain"])}),
              flush=True)
    if a.out:
        save(a.out, runs.get("kernels", runs[a.modes[0]])[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
