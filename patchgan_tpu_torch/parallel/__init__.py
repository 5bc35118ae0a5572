from .mesh import DataMesh, init_from_env, shutdown, torchrun_env
from .multihost import process_local_range

__all__ = ['DataMesh', 'init_from_env', 'shutdown', 'torchrun_env',
           'process_local_range']
