"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (see ``_build`` for how they are compiled and loaded)."""

from .conv_norm_act import conv_norm_act, conv_norm_act_plain
from .convt_norm_act import (convt_norm_act, convt_norm_act_plain,
                             pack_convt_weight, pack_convt_weight_plain)
from .norm_act import (instance_norm_act, instance_norm_act_backward,
                       instance_norm_act_backward_plain,
                       instance_norm_act_plain)
from .thin_conv import (pack_thin_weight, pack_thin_weight_plain,
                        thin_conv3x3, thin_conv3x3_plain, thin_conv3x3_wgrad,
                        thin_conv3x3_wgrad_plain)

# every kernel wrapper; each carries a ``launches`` count
WRAPPERS = (instance_norm_act, conv_norm_act, convt_norm_act,
            instance_norm_act_backward, thin_conv3x3, thin_conv3x3_wgrad)

__all__ = ['conv_norm_act', 'conv_norm_act_plain', 'convt_norm_act',
           'convt_norm_act_plain', 'instance_norm_act',
           'instance_norm_act_backward', 'instance_norm_act_backward_plain',
           'instance_norm_act_plain', 'pack_convt_weight',
           'pack_convt_weight_plain', 'pack_thin_weight',
           'pack_thin_weight_plain', 'thin_conv3x3', 'thin_conv3x3_plain',
           'thin_conv3x3_wgrad', 'thin_conv3x3_wgrad_plain', 'WRAPPERS']
