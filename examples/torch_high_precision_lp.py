#!/usr/bin/env python
"""High-precision LP with duals on loraine_tpu_torch (the counterpart of
examples/high_precision_lp.py; the reference's `examples/k.jl`, which runs
Loraine at MultiFloats Float64x2): max 2x s.t. 1 <= x <= 2, solved in the
double-double mode (`precision='dd'`) with shadow prices read off the
constraint duals.

    python examples/torch_high_precision_lp.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from loraine_tpu_torch.modeling import Model

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

m = Model()
x = m.free_var("x")
c1 = m.add_constraint(x >= 1)
c2 = m.add_constraint(x <= 2)
m.maximize(2 * x)
res = m.solve({"eDIMACS": 1e-12, "precision": "dd", "verb": 0}, device=args.device)

print(f"status    : {res.status_name}")
print(f"objective : {res.objective}")
print(f"x         : {res.value(x)}")
print(f"shadow c1 : {res.dual(c1)}")
print(f"shadow c2 : {res.dual(c2)}")

assert res.status == 1
np.testing.assert_allclose(res.objective, 4.0, rtol=1e-9)
np.testing.assert_allclose(res.value(x), 2.0, rtol=1e-9)
assert abs(res.dual(c1)) < 1e-8
np.testing.assert_allclose(abs(res.dual(c2)), 2.0, rtol=1e-8)
print("matches k.jl (obj 4, shadow prices 0 and 2) at dd accuracy")
