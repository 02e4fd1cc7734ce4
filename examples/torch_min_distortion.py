#!/usr/bin/env python
"""Minimum-distortion Euclidean embedding of a finite metric with
loraine_tpu_torch (the counterpart of examples/min_distortion.py; the
reference's `examples/ex_dist.jl`): the smallest c^2 such that the star
metric D embeds in l2 with distortion c. Known optimum: c^2 = 4/3 with the
tetrahedral embedding Q.

    python examples/torch_min_distortion.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from loraine_tpu_torch.models import minimum_distortion

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

c2, Q = minimum_distortion(device=args.device)
print(f"minimal squared distortion c^2 = {c2:.6f}")
print("embedding Gram matrix Q =")
print(np.array_str(np.asarray(Q), precision=4, suppress_small=True))

Qref = np.array(
    [[0, 0, 0, 0], [0, 4, -2, -2], [0, -2, 4, -2], [0, -2, -2, 4]], dtype=float
) / 3.0
assert abs(c2 - 4.0 / 3.0) < 1e-4
np.testing.assert_allclose(Q, Qref, atol=1e-4)
print("matches the reference optimum (4/3, tetrahedron)")
