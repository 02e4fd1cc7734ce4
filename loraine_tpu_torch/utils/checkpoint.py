"""Iterate checkpoint / resume. Port of `loraine_tpu/utils/checkpoint.py`.

The reference keeps no checkpointing (SURVEY section 5). The state is saved
as a flat .npz in the JAX package's layout, key for key: ``__ngroups__``,
``__has_lin__``, ``__has_dd2__`` and ``leaf_i`` in the order in which
`jax.tree_util.tree_flatten` lists the JAX `IPMState`'s data fields (None
fields contribute no leaf): X..., S..., y, [X_lin, S_lin], sigma, then the
dd2 tails X_lo..., S_lo..., y_lo, [X_lin_lo, S_lin_lo]. So a checkpoint
written by either package loads in the other.

    res = ltt.solve(problem, {"maxit": 5})
    ltt.save_state("ckpt.npz", res.final_state)
    state = ltt.load_state("ckpt.npz")
    res2 = ltt.Solver(problem, opts, initial_state=state).solve()  # resumes

As in the JAX package, `load_state` reads back the tails X_lo, S_lo and
y_lo of a dd2 checkpoint but not the LP tails X_lin_lo, S_lin_lo, which are
dropped. `Solver._normalize_tails` fills tails only when X_lo is None, so a
dd2 resume of a problem with an LP cone reaches the step with
X_lin_lo = None (ROADMAP Queue C).
"""
from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from ..ipm.state import IPMState
from .device import resolve_device

__all__ = ["save_state", "load_state"]


def _leaves(state: IPMState) -> List[torch.Tensor]:
    """The state's tensors in the JAX `tree_flatten` order."""
    out: List[torch.Tensor] = [*state.X, *state.S, state.y]
    if state.X_lin is not None:
        out += [state.X_lin, state.S_lin]
    out.append(state.sigma)
    if state.X_lo is not None:
        out += [*state.X_lo, *state.S_lo, state.y_lo]
        if state.X_lin_lo is not None:
            out += [state.X_lin_lo, state.S_lin_lo]
    return out


def save_state(path: str, state: IPMState) -> None:
    host = [x.detach().cpu().numpy() for x in _leaves(state)]
    np.savez(
        path,
        __ngroups__=np.int64(len(state.X)),
        __has_lin__=np.int64(state.X_lin is not None),
        __has_dd2__=np.int64(state.X_lo is not None),
        **{f"leaf_{i}": a for i, a in enumerate(host)},
    )


def load_state(path: str, dtype: torch.dtype = torch.float64,
               device: Union[str, torch.device] = "cuda") -> IPMState:
    """The state saved at ``path``, on ``device`` ('cuda' by default; raises
    without a card)."""
    device = resolve_device(device)
    z = np.load(path)
    ngroups = int(z["__ngroups__"])
    has_lin = bool(z["__has_lin__"])
    has_dd2 = bool(z["__has_dd2__"]) if "__has_dd2__" in z.files else False
    nleaves = len([k for k in z.files if k.startswith("leaf_")])
    leaves = [torch.as_tensor(z[f"leaf_{i}"]).to(device=device, dtype=dtype)
              for i in range(nleaves)]
    pos = 0

    def take(k: int):
        nonlocal pos
        out = leaves[pos:pos + k]
        pos += k
        return out

    X, S = tuple(take(ngroups)), tuple(take(ngroups))
    (y,) = take(1)
    X_lin, S_lin = take(2) if has_lin else (None, None)
    (sigma,) = take(1)
    if not has_dd2:
        return IPMState(X=X, S=S, y=y, X_lin=X_lin, S_lin=S_lin, sigma=sigma)
    X_lo, S_lo = tuple(take(ngroups)), tuple(take(ngroups))
    (y_lo,) = take(1)
    return IPMState(X=X, S=S, y=y, X_lin=X_lin, S_lin=S_lin, sigma=sigma,
                    X_lo=X_lo, S_lo=S_lo, y_lo=y_lo)
