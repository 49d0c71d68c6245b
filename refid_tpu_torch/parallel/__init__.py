from refid_tpu_torch.parallel.mesh import (
    Mesh, init_distributed, make_mesh, replicate, shard_batch,
)
from refid_tpu_torch.parallel.spatial import (
    SpatialPlan, halo_exchange, row_split, spatial_scope,
)

__all__ = ["Mesh", "init_distributed", "make_mesh", "replicate", "shard_batch",
           "SpatialPlan", "halo_exchange", "row_split", "spatial_scope"]
