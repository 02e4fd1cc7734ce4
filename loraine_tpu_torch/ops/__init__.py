from . import cg, eigh, jacobi, linalg, nt_scaling, pcg, precond, schur

__all__ = ["cg", "eigh", "jacobi", "linalg", "nt_scaling", "pcg", "precond", "schur"]
