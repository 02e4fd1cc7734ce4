#!/usr/bin/env python
"""Correlation bounds via the declarative modeling layer of
loraine_tpu_torch (the counterpart of examples/modeling_correlation.py; the
reference's `examples/ex_corr.jl`, written the way a JuMP user would).

    python examples/torch_modeling_correlation.py [--device cpu]
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


def bound(sense):
    m = Model()
    X = m.psd_var(3)
    for i in range(3):
        m.add_constraint(X[i, i] == 1)
    m.add_constraint(X[0, 1] >= -0.2)
    m.add_constraint(X[0, 1] <= -0.1)
    m.add_constraint(X[1, 2] >= 0.4)
    m.add_constraint(X[1, 2] <= 0.5)
    (m.maximize if sense == "max" else m.minimize)(X[0, 2])
    res = m.solve({"eDIMACS": 1e-8, "initpoint": 1}, device=args.device)
    assert res.status == 1
    return res.objective


upper = bound("max")
lower = bound("min")
print(f"rho_AC in [{lower:.10f}, {upper:.10f}]")
np.testing.assert_allclose(upper, 0.8719210472, rtol=1e-6)
np.testing.assert_allclose(lower, -0.9779977649, rtol=1e-6)
