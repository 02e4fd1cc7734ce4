"""Multi-process runtime glue. Port of `loraine_tpu/parallel/distributed.py`.

One process per rank (explicit SPMD, `parallel/mesh.py`). ``initialize``
wraps `torch.distributed.init_process_group` with an explicit backend:

- 'nccl' (the default on 'cuda'): one card per rank, across the cards of a
  node;
- 'gloo' (the default on 'cpu'): CPU ranks, or several ranks that share
  one card (``backend='gloo', device='cuda'``; NCCL refuses two ranks on
  one device). Gloo moves CUDA tensors through the host, so such runs
  check the distributed algorithm, not NCCL's scaling.

A rank's device is ``cuda:{local_rank % device_count}``. The process group
gets a finite timeout, so a rank that diverges from the others fails the
run instead of hanging it.

Usage, one process per rank (``torchrun`` sets the environment that the
no-argument call reads)::

    from loraine_tpu_torch.parallel import distributed, make_mesh, shard_problem
    distributed.initialize()
    problem = ltt.load_problem(path, opts, device=distributed.device())
    mesh = make_mesh((1, distributed.world_size()))
    res = ltt.solve(shard_problem(problem, mesh), opts, device=distributed.device())
"""
from __future__ import annotations

import datetime
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "device", "world_size", "rank", "shutdown", "launch"]

_device: Optional[torch.device] = None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: str = "cuda",
    timeout_s: float = 600.0,
) -> None:
    """Join the process group (idempotent).

    ``coordinator_address``: 'host:port' (rank 0 serves the rendezvous
    there), an init URL ('tcp://host:port', 'file:///path'), or None for
    the torchrun environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
    LOCAL_RANK). ``device``: 'cuda' or 'cpu', where this rank computes.
    ``backend``: 'nccl' or 'gloo'; None picks 'nccl' on 'cuda' and 'gloo'
    on 'cpu'."""
    global _device
    if dist.is_initialized():
        return
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if backend == "nccl" and device != "cuda":
        raise ValueError("backend 'nccl' needs device='cuda'")
    if coordinator_address is None:
        init = "env://"
        num_processes = int(os.environ.get("WORLD_SIZE", num_processes or 1))
        process_id = int(os.environ.get("RANK", process_id or 0))
    else:
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
    local = int(os.environ.get("LOCAL_RANK", process_id))
    if device == "cuda":
        _device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(_device)
    else:
        _device = torch.device("cpu")
    dist.init_process_group(
        backend, init_method=init, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def is_initialized() -> bool:
    return dist.is_initialized()


def device() -> torch.device:
    """This rank's device (set by `initialize`)."""
    if _device is None:
        raise RuntimeError("call loraine_tpu_torch.parallel.distributed.initialize() first")
    return _device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    """Leave the process group (a no-op when not initialized)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def launch(cmd: Sequence[str], nproc: int, timeout: float,
           env: Optional[Dict[str, str]] = None) -> List[str]:
    """Run ``cmd`` (a Python command line, without the interpreter) as
    ``nproc`` ranks and return their outputs (stdout and stderr merged), in
    rank order. Each rank gets ``--rank r --nproc N --init file://...``
    appended: a FileStore rendezvous in a fresh temporary directory, so no
    port is chosen. Children run with OMP_NUM_THREADS=1 unless ``env`` says
    otherwise. A rank that fails, or a run past ``timeout`` seconds, kills
    the others and raises RuntimeError with the ends of the outputs."""
    tmp = tempfile.mkdtemp(prefix="ltt_launch_")
    init = "file://" + os.path.join(tmp, "store")
    full_env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(nproc)]
    procs = [
        subprocess.Popen(
            [sys.executable, *cmd, "--rank", str(r), "--nproc", str(nproc), "--init", init],
            stdout=logs[r], stderr=subprocess.STDOUT, env=full_env,
        )
        for r in range(nproc)
    ]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}" if bad \
                    else f"timed out after {timeout:.0f} s"
                break
            time.sleep(0.05)
        else:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        tails = "\n".join(f"--- rank {r} ---\n{o[-3000:]}" for r, o in enumerate(outs))
        raise RuntimeError(f"{failed}\n{tails}")
    return outs
