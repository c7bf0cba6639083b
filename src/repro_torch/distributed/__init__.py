"""Sharding helpers of the paper pipeline over ``torch.distributed``
(port of ``repro.distributed``: the edge partition, meshes and worlds)."""
from .sharding import (batch_axes, cluster_mesh, current_mesh, data_mesh,
                       edge_partition, entry_world, pad_to_shards, use_mesh,
                       world)

__all__ = ["world", "entry_world", "cluster_mesh", "data_mesh", "use_mesh",
           "current_mesh", "batch_axes", "edge_partition", "pad_to_shards"]
