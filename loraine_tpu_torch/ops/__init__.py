from . import eigh, jacobi, linalg, nt_scaling, schur

__all__ = ["eigh", "jacobi", "linalg", "nt_scaling", "schur"]
