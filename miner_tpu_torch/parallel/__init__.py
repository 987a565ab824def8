from miner_tpu_torch.parallel.mesh import Mesh, MeshConfig
from miner_tpu_torch.parallel.sharding import gather_rows, process_row_range, replicate, shard_batch

__all__ = [
    "MeshConfig",
    "Mesh",
    "gather_rows",
    "process_row_range",
    "replicate",
    "shard_batch",
]
