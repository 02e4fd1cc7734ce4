#!/usr/bin/env python
"""Max-cut SDP relaxation + hyperplane rounding with loraine_tpu_torch (the
counterpart of examples/maxcut.py; the reference's `examples/ex_maxcut.jl`).

    python examples/torch_maxcut.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from loraine_tpu_torch.models import solve_maxcut

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

weights = np.array(
    [[0, 1, 5, 0], [1, 0, 0, 9], [5, 0, 0, 2], [0, 9, 2, 0]], dtype=float
)
S, T, value = solve_maxcut(weights, device=args.device)
print(f"relaxation value: {value}")
print(f"cut: S = {S}, T = {T}")
assert sorted([tuple(sorted(S)), tuple(sorted(T))]) == [(0, 3), (1, 2)]
