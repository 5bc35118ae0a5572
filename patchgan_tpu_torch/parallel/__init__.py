from .mesh import (DataMesh, DeviceMesh, HybridMesh, ModelMesh, default_mesh,
                   init_from_env, shutdown, torchrun_env)
from .multihost import process_local_range
from .sharding import (DATA_AXIS, MODEL_AXIS, gather_hybrid_state,
                       hybrid_mesh, model_parallel_shardings,
                       place_hybrid_state, rank_grid)
from .spatial import (SPATIAL_AXIS, SpatialMesh, replicate_spatial,
                      shard_batch_spatial, spatial_mesh)

__all__ = ['DataMesh', 'DeviceMesh', 'HybridMesh', 'ModelMesh',
           'default_mesh', 'init_from_env', 'shutdown', 'torchrun_env',
           'process_local_range', 'DATA_AXIS', 'MODEL_AXIS',
           'gather_hybrid_state', 'hybrid_mesh', 'model_parallel_shardings',
           'place_hybrid_state', 'rank_grid', 'SPATIAL_AXIS', 'SpatialMesh',
           'replicate_spatial', 'shard_batch_spatial', 'spatial_mesh']
