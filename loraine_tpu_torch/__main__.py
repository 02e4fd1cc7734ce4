"""Command-line interface: solve SDPA / POEMA-JSON files directly. Port of
`loraine_tpu/__main__.py`, with one flag more, ``--device`` ('cuda' by
default; 'cpu' runs the kernels' plain versions on the CPU).

    python -m loraine_tpu_torch solve path/to/problem.dat-s --kit 0 --eDIMACS 1e-6
    python -m loraine_tpu_torch solve path/to/problem.json --device cpu
    python -m loraine_tpu_torch bench path/to/problem.dat-s

(the reference's `examples/solve_sdpa.jl` and `TBD/solve_json.jl` flows
without a modeling layer).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _add_option_args(p: argparse.ArgumentParser) -> None:
    import dataclasses

    from .config import Options

    for f in dataclasses.fields(Options):
        if f.type in ("int", int, "Optional[int]"):
            p.add_argument(f"--{f.name}", type=int, default=None)
        elif f.type in ("float", float):
            p.add_argument(f"--{f.name}", type=float, default=None)
        else:
            p.add_argument(f"--{f.name}", type=str, default=None)


def _collect_options(args) -> dict:
    import dataclasses

    from .config import Options

    opts = {}
    for f in dataclasses.fields(Options):
        v = getattr(args, f.name, None)
        if v is not None:
            opts[f.name] = v
    return opts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="loraine_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("solve", help="solve an SDPA .dat-s file")
    sp.add_argument("file")
    sp.add_argument("--json", action="store_true", help="print a JSON summary")
    sp.add_argument(
        "--phases", action="store_true",
        help="print the per-phase device-time breakdown after the solve "
        "(equivalent to timing=2; the reference's TimerOutputs tree, "
        "`src/Loraine.jl:88-90`)",
    )
    _add_option_args(sp)

    bp = sub.add_parser("bench", help="time a solve (warm + steady-state)")
    bp.add_argument("file")
    _add_option_args(bp)
    for p in (sp, bp):
        p.add_argument("--device", default="cuda",
                       help="'cuda' (default; needs a card) or 'cpu'")

    args = ap.parse_args(argv)
    from .ipm.solver import solve_json, solve_sdpa

    def _solve(path, opts):
        # .json files take the POEMA-JSON path, anything else SDPA
        if str(path).endswith(".json"):
            return solve_json(path, opts, device=args.device)
        return solve_sdpa(path, opts, device=args.device)

    opts = _collect_options(args)
    if args.cmd == "solve":
        if getattr(args, "phases", False):
            opts["timing"] = max(2, int(opts.get("timing", 2)))
            opts.setdefault("verb", 1)
        res = _solve(args.file, opts)
        if args.json:
            print(
                json.dumps(
                    {
                        "status": res.status_name,
                        "objective": res.objective,
                        "dual_objective": res.dual_objective,
                        "iterations": res.iterations,
                        "cg_iterations": res.cg_iterations,
                        "dimacs": res.dimacs,
                        "solve_time": res.solve_time,
                    }
                )
            )
        return 0 if res.status == 1 else res.status

    if args.cmd == "bench":
        opts.setdefault("verb", 0)
        _solve(args.file, dict(opts))  # warm-up/compile
        t0 = time.perf_counter()
        res = _solve(args.file, dict(opts))
        wall = time.perf_counter() - t0
        per_it = sum(res.iteration_times[1:]) / max(1, len(res.iteration_times) - 1)
        print(
            json.dumps(
                {
                    "status": res.status_name,
                    "objective": res.objective,
                    "iterations": res.iterations,
                    "wall_s": round(wall, 4),
                    "per_iteration_s": round(per_it, 5),
                    "iters_per_sec": round(1.0 / per_it, 3),
                }
            )
        )
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
