from .activations import apply_activation
from .conv import conv2d, conv_transpose2d
from .norm import instance_norm

__all__ = ['apply_activation', 'conv2d', 'conv_transpose2d',
           'instance_norm']
