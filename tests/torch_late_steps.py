"""dd2 steps past theta1's last iterate, in either package (not a test
module): what happens to the dd2 floors when the IPM steps on from where
the solve stopped, under the f64 and the dd NT scaling.

  # the port on a device: theta1 at 'dd2' (tests/test_precision.py's
  # options; --maxit K stops it after K iterations), its final state saved
  # to STATE, then --steps steps under each NT scaling from it (the port's
  # default eigen modes)
  python tests/torch_late_steps.py solve STATE --device cuda

  # from a saved state (either package's .npz checkpoint layout), STEPS
  # steps under each NT scaling, in the JAX package or the port on the CPU,
  # both under EXACT_MODES (tests/torch_cases.py)
  JAX_PLATFORMS=cpu python tests/torch_late_steps.py step STATE --pkg jax
  python tests/torch_late_steps.py step STATE --pkg port

Prints one line per step: the package, the NT scaling, the step and its
stats (err1 is the residual at the step's start, the reference's
convention)."""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

THETA1 = os.path.join(HERE, "data", "theta1.dat-s")
DD2 = {"kit": 0, "eDIMACS": 5e-13, "initpoint": 1, "verb": 0, "precision": "dd2", "maxit": 30,
       "datasparsity": 0}
KEYS = ("dimacs", "err1", "err3", "err5", "mu", "alpha_min", "beta_min", "nt_ok", "h_ok")


def _port(device, opts):
    import loraine_tpu_torch as ltt
    from loraine_tpu_torch.ipm.step import step

    o = ltt.Options.from_dict(opts).validated()
    p = ltt.load_problem(THETA1, o, device=device)
    o = o.resolved(p, device)
    return lambda st: step(p, st, o, 1e-3), lambda s: {k: float(s.to_host()[k]) for k in KEYS}


def _jax(opts):
    import loraine_tpu as lt
    from loraine_tpu.ipm.step import build_step

    o = lt.Options.from_dict(opts).validated()
    p = lt.load_problem(THETA1, o)
    f = build_step(o, -1)
    return lambda st: f(p, st, 1e-3), lambda s: {k: float(getattr(s, k)) for k in KEYS}


def steps(pkg: str, state, opts: dict, n: int) -> None:
    for nt in ("f64", "dd"):
        o = dict(opts, nt_precision=nt)
        call, host = _jax(o) if pkg == "jax" else _port(state[1], o)
        st = state[0]
        for k in range(n):
            t0 = time.perf_counter()
            st, stats = call(st)
            print(f"{pkg} nt={nt} step {k + 1}: {json.dumps(host(stats))} "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("solve", "step"))
    ap.add_argument("state")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pkg", choices=("jax", "port"), default="port")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--maxit", type=int, default=DD2["maxit"])
    a = ap.parse_args()
    if a.mode == "solve":
        import torch

        import loraine_tpu_torch as ltt

        torch.backends.cuda.matmul.allow_tf32 = False
        r = ltt.solve_sdpa(THETA1, dict(DD2, maxit=a.maxit), device=a.device)
        print(f"theta1 dd2 {a.device}: {r.status_name} {r.iterations} iterations, objective "
              f"{r.objective!r}, dimacs {r.dimacs:.3e}, errs {r.errs}", flush=True)
        ltt.save_state(a.state, r.final_state)
        steps("port", (r.final_state, a.device), DD2, a.steps)
        return
    from torch_cases import EXACT_MODES

    if a.pkg == "jax":
        from loraine_tpu.utils.checkpoint import load_state

        state = (load_state(a.state), None)
    else:
        from loraine_tpu_torch.utils.checkpoint import load_state

        state = (load_state(a.state, device="cpu"), "cpu")
    steps(a.pkg, state, dict(DD2, **EXACT_MODES), a.steps)


if __name__ == "__main__":
    main()
