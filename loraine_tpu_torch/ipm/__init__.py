from .solver import Result, Solver, solve
from .state import IPMState, StepStats

__all__ = ["IPMState", "StepStats", "solve", "Result", "Solver"]
