"""Model families (port of `loraine_tpu/models`): problem builders and
solvers for the reference's examples. Each takes ``device=`` ('cuda' by
default; raises without a card)."""
from .maxcut import maxcut_problem, solve_maxcut
from .theta import lovasz_theta_problem
from .correlation import correlation_bounds
from .distortion import minimum_distortion
from .lp import lp_problem

__all__ = [
    "maxcut_problem",
    "solve_maxcut",
    "lovasz_theta_problem",
    "correlation_bounds",
    "minimum_distortion",
    "lp_problem",
]
