"""Device resolution for the port. No JAX counterpart: the JAX package lets
the backend pick the device, the port names it explicitly.

The default device everywhere is ``"cuda"``, and asking for it without a
card raises: the port never falls back to the CPU on its own. Tests and CPU
runs pass ``device="cpu"``."""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        # TF32 keeps ~3 decimal digits: it would silently degrade the f32
        # Jacobi seeds and every f32 matmul of the refinement inputs
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 must be False for "
                "loraine_tpu_torch"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev
