#!/usr/bin/env python3
"""The readings behind the limits of ``correct``; the benchmark's own runs
do not run this.

    python3 sdpbench/control.py --workload <cell> [--program-seeds A,B,...]
        [--seconds S] [--control-seeds X,Y,Z] [--control-requests R]

In one process (set-up is paid once): the program's own runs of the cell,
a window of S seconds for each program seed, which give the lower
readings; beside each, the same answers rounded to float32 (the nearest
precision below the float64 that the configurations state: the best a
float32 solver could return, judged in float64); then the program's own
float32 path (option ``dtype`` 'float32', the problem built in float32)
on R requests of each control seed. The two controls give the upper
readings. One JSON line per run: each number compared (the worst over the
run's requests, as in a benchmark run), whether the cell's limits pass
it, and the statuses and iterations. A control run of the float32 path
reads fewer requests than a window holds, and its number is a worst case
over them, so fewer requests can only read lower: its upper readings are
conservative. Exits 3 without a card.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import harness  # noqa: E402


def rounded(answer: dict) -> dict:
    """``answer`` held in float32, as a float32 solver would return it."""
    def f32(a):
        return None if a is None else np.asarray(a, np.float32).astype(np.float64)

    return {"X": [f32(x) for x in answer["X"]], "S": [f32(s) for s in answer["S"]],
            "y": f32(answer["y"]), "X_lin": f32(answer["X_lin"]),
            "objective": float(np.float32(answer["objective"]))}


def _record(cell, side, seed, window_s, records, insts):
    checks = harness.judge(cell, records, insts)
    return {"side": side, "workload": cell.name, "seed": seed, "requests": len(records),
            "window_s": window_s,
            "statuses": [r["status"] for r in records],
            "iterations": [r["iterations"] for r in records],
            "numbers": {k: c["value"] for k, c in checks.items()},
            "passes": all(c["value"] <= c["limit"] for c in checks.values())}


def readings(cell: harness.Cell, device: str, program_seeds, seconds: float,
             control_seeds, control_requests: int, log=print):
    """Yield one record per run: the program's on each program seed, each
    followed by its answers rounded to float32, then the float32 path's on
    each control seed."""
    for side, seeds, opts, budget in (
            ("program", program_seeds, None, None),
            ("control-f32-path", control_seeds, {**cell.options, "dtype": "float32"},
             control_requests)):
        if not seeds:
            continue
        ses = harness.open_session(cell, device, False, options=opts, log=log)
        for seed in seeds:
            _, window_s, records, insts, _, _, _ = harness.measure(
                ses, seed, seconds if budget is None else float("inf"), budget, log=log)
            yield _record(cell, side, seed, window_s, records, insts)
            if side == "program":
                f32 = [dict(r, answer=rounded(r["answer"])) for r in records]
                yield _record(cell, "control-f32-answers", seed, window_s, f32, insts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-requests", type=int, default=4)
    args = ap.parse_args(argv)
    seeds = [[int(s) for s in v.split(",") if s] for v in (args.program_seeds, args.control_seeds)]
    cell = harness.load_cell(args.workload)
    harness.set_environment()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("error: no CUDA device", file=sys.stderr)
        return 3
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    print(f"# card: {harness.card_limit()}", flush=True)
    t = time.perf_counter()
    for rec in readings(cell, "cuda", seeds[0], args.seconds, seeds[1],
                        args.control_requests, log):
        print(json.dumps(harness.finite(rec), allow_nan=False), flush=True)
    print(f"# {time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
