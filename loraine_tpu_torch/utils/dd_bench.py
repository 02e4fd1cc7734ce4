"""Time the dd NT scaling's kernels D1-D3 (`csrc/dd_linalg.cu`) on a card.

Each kernel is timed two ways: a call through its wrapper (CUDA events
around 20 calls, the host's work included) and the kernel alone (CUDA
events around each of 20 launches of its C entry on copies of the inputs,
queued behind a device sleep so that the host's launch cost stays out of
the window). Inputs: clustered, IPM-like spectra from a seed (half the
eigenvalues at 1, a graded tail to 1e-6), lo parts ~1e-17 of hi; D1 runs
6 sweeps (the warm default) to m 84 and 2 past it. Where this checkout's
library can force a plan, D1 also runs in every cluster size at (1, 56)
and in "block" beside "cluster" across small m (how `lt_dd_plan`'s rule
was chosen).

    python3 -m loraine_tpu_torch.utils.dd_bench [--shapes 1x56 2x96 ...]
    python3 loraine_tpu_torch/utils/dd_bench.py --root OTHER_CHECKOUT

With ``--root`` the package is imported from that checkout (an earlier
version of the kernels; plans are not forced there), so two versions are
timed on one card in one call. Prints one JSON line per measurement, then
the card's name and power limit. Needs a card; no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

SHAPES = ((1, 8), (1, 16), (1, 18), (1, 56), (2, 56), (1, 96), (2, 96))
# D1 in every cluster size at theta1's m, and "block" beside "cluster" to m 40
FORCED_56 = (1, 2, 4, 7, 8, 14, 16, -16)
BLOCK_VS_CLUSTER = (8, 12, 16, 18, 20, 24, 32, 40)
SLEEP_CYCLES = 400_000  # ~0.2 ms at 1.98 GHz: longer than a wrapper's host work


def clustered(nb: int, m: int, seed: int) -> np.ndarray:
    """Symmetric [nb, m, m]: half the spectrum at 1, a graded tail to 1e-6."""
    rng = np.random.default_rng(seed)
    d = np.concatenate([np.full((nb, m // 2), 1.0),
                        10.0 ** rng.uniform(-6, 0, (nb, m - m // 2))], axis=1)
    Q = np.linalg.qr(rng.standard_normal((nb, m, m)))[0]
    A = Q @ (d[:, :, None] * np.eye(m)) @ Q.transpose(0, 2, 1)
    return (A + A.transpose(0, 2, 1)) / 2


def call_ms(fn, reps: int = 20) -> float:
    """Mean ms of a call of ``fn`` (CUDA events around ``reps`` calls after
    a warm-up): the wrapper's host work and copies included."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def alone_ms(prep, launch, reps: int = 20) -> float:
    """Mean device ms of one launch alone: ``prep`` restores the inputs,
    then a device sleep, then CUDA events around ``launch`` (which enqueues
    the kernel and nothing else)."""
    prep()
    launch()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        prep()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        launch()
        e1.record()
        marks.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / reps


def launcher(dl, kind: str, *args, sweeps: int = 0, force: int = 0):
    """(prep, launch) of one D kernel call on copies of its inputs, through
    its C entry; works with this checkout's library and with that of the
    first D1-D3 (a pairs table argument, D2's product scratch)."""
    new = hasattr(dl, "plan_for")
    dev = args[0].hi.device
    nb, m = args[0].hi.shape[0], args[0].hi.shape[-1]
    lib = dl._lib()
    src = [x.contiguous() for a in args for x in a]
    work = [x.clone() for x in src]
    ptr = [t.data_ptr() for t in work]

    def prep():
        for w, s in zip(work, src):
            w.copy_(s)

    if kind == "jacobi":
        if new:
            S = dl._scratch(nb * dl.plan_for("jacobi", m, force)[2], dev)
            extra = [None if S is None else S.data_ptr(), nb, m, sweeps, force]
        else:
            extra = [dl._pairs_on(m, dev).data_ptr(), nb, m, sweeps]
        fn, argv = lib.lt_dd_jacobi, ptr + extra
    elif kind == "chol":
        out = [torch.empty_like(work[0]) for _ in range(2)]
        ok = torch.empty((nb,), dtype=torch.bool, device=dev)
        if new:
            S = dl._scratch(nb * dl.plan_for("chol", m)[2], dev)
            scratch = [None if S is None else S.data_ptr()]
        else:
            S = torch.empty((2, nb, m, m), dtype=torch.float64, device=dev)
            scratch = [S[0].data_ptr(), S[1].data_ptr()]
        fn, argv = lib.lt_dd_chol, ptr + [t.data_ptr() for t in out] + scratch + [
            ok.data_ptr(), nb, m]
    else:
        out = [torch.empty_like(work[0]) for _ in range(2)]
        fn, argv = lib.lt_dd_gemm, ptr + [t.data_ptr() for t in out] + [nb, m, m, m]
    return prep, lambda: dl._launch(fn, dev, *argv)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="import loraine_tpu_torch from this checkout")
    ap.add_argument("--shapes", nargs="*", help="NBxM, e.g. 1x56 (default: %(default)s)",
                    default=[f"{nb}x{m}" for nb, m in SHAPES])
    ap.add_argument("--out", help="also append the JSON lines to this file")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dd_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if a.root:
        sys.path.insert(0, os.path.abspath(a.root))
    from loraine_tpu_torch.ops import dd_linalg as dl
    from loraine_tpu_torch.ops.dd import DD

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(dl.__file__))))
    out = open(a.out, "a") if a.out else None

    def emit(rec):
        rec = dict(rec, root=root, card=card)
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")

    rng = np.random.default_rng(42)

    def dd_in(x):
        x = torch.from_numpy(x)
        return DD(x.cuda(), (x * 1e-17 * torch.from_numpy(rng.standard_normal(x.shape))).cuda())

    def inputs(nb, m):
        A = dd_in(clustered(nb, m, seed=m))
        eye = torch.eye(m, dtype=torch.float64, device="cuda").expand(nb, m, m).contiguous()
        return A, dd_in(rng.standard_normal((nb, m, m))), DD(eye, torch.zeros_like(eye))

    for shape in a.shapes:
        nb, m = (int(t) for t in shape.split("x"))
        A, B, V0 = inputs(nb, m)
        sweeps = 6 if m <= 84 else 2
        for kind, call, args in (
                ("jacobi", lambda: dl.dd_jacobi_cuda(A, V0, sweeps), (A, V0)),
                ("chol", lambda: dl.dd_chol_cuda(A), (A,)),
                ("gemm", lambda: dl.dd_matmul_cuda(A, B), (A, B))):
            regime = dl.regime_for(kind, m) if kind != "gemm" else None
            emit({"kernel": kind, "shape": [nb, m], "sweeps": sweeps if kind == "jacobi" else None,
                  "regime": regime, "call_ms": call_ms(call),
                  "alone_ms": alone_ms(*launcher(dl, kind, *args, sweeps=sweeps))})
    if hasattr(dl, "plan_for"):
        A, _, V0 = inputs(1, 56)
        for force in FORCED_56:
            emit({"kernel": "jacobi", "shape": [1, 56], "sweeps": 6, "force": force,
                  "plan": list(dl.plan_for("jacobi", 56, force)[:2]),
                  "alone_ms": alone_ms(*launcher(dl, "jacobi", A, V0, sweeps=6, force=force))})
        for m in BLOCK_VS_CLUSTER:
            A, _, V0 = inputs(1, m)
            for force in sorted({1, min(8, m // 2), min(16, m // 2)}):
                emit({"kernel": "jacobi", "shape": [1, m], "sweeps": 6, "force": force,
                      "plan": list(dl.plan_for("jacobi", m, force)[:2]),
                      "alone_ms": alone_ms(*launcher(dl, "jacobi", A, V0, sweeps=6,
                                                     force=force))})
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
