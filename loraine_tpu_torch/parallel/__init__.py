"""Distribution: the ('blocks', 'schur') mesh over torch.distributed, one
process per rank. Port of `loraine_tpu/parallel/`."""
from . import distributed
from .mesh import Mesh, auto_mesh, make_mesh, shard_problem, shard_state

__all__ = ["Mesh", "auto_mesh", "make_mesh", "shard_problem", "shard_state", "distributed"]
