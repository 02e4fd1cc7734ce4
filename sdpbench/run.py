#!/usr/bin/env python3
"""The benchmark of loraine_tpu_torch on NVIDIA H100s: one run of one cell.

    python3 sdpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the kernel libraries, the
instance, the relabelings, one warm solve) is timed as ``setup_s``; then
requests run back to back for ``--seconds``; then the plain reference
judges every answer of the window. With ``--trace 0`` the last line of
standard output is the cell's end-to-end metrics, with ``--trace 1`` (a
`torch.profiler` trace of the whole window) its per-layer metrics; the
numbers compared, each beside its limit, close standard error and the
result's line. Exits 3 without a card (or fewer than the cell asks for)
and 4 when a forbidden module (jax, jaxlib, flax, loraine_tpu) was loaded;
neither prints a result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative integer")

    import harness

    harness.set_environment()
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s), found {have}; "
              "no result", file=sys.stderr)
        return 3

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                           T_START, bench, log=lambda s: print(s, file=sys.stderr, flush=True))
    if out.pop("_forbidden") or harness.forbidden_modules():
        print(f"error: the process loaded {harness.forbidden_modules()}; no result",
              file=sys.stderr)
        return 4
    run = out.pop("_run")
    opt = run.optimal
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in run.setup_parts.items())
    rest = run.setup_s - sum(run.setup_parts.values())
    parts += f", the rest (torch's import, the card check) {rest:.3f} s"
    print(f"# card: {harness.card_limit()}")
    print(f"# setup_s {run.setup_s:.3f}: {parts}")
    print(f"# window {run.window_s:.3f} s: {len(run.requests)} requests, {len(opt)} OPTIMAL "
          f"(the samples of solve_s_p95); (status, iterations, wall ms) of each in order: "
          f"{[(r['status'], r['iterations'], round(1e3 * r['wall_s'], 1)) for r in run.requests]}")
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.finite(out), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
