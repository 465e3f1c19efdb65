# Mesh helpers of the port: ("data", "model") and ("pod", "data", "model") process
# groups over torch.distributed, the sharding rules and the collectives of the mesh steps.
from .mesh import AXES, POD_AXES, AbstractMesh, Mesh, default_mesh, make_mesh  # noqa: F401
from .partitioning import (  # noqa: F401
    DP_AXES, TP_AXIS, P, batch_pspec, cache_pspecs, gather_caches, gather_tensor, gather_tree,
    param_pspecs, shard_caches, shard_tensor, shard_tree,
)
