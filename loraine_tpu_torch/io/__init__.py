from .sdpa import SDPAData, read_sdpa, write_sdpa

__all__ = ["SDPAData", "read_sdpa", "write_sdpa"]
