from .mesh import (DataMesh, DeviceMesh, default_mesh, init_from_env,
                   shutdown, torchrun_env)
from .multihost import process_local_range

__all__ = ['DataMesh', 'DeviceMesh', 'default_mesh', 'init_from_env',
           'shutdown', 'torchrun_env', 'process_local_range']
