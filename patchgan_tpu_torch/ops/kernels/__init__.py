"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (see ``_build`` for how they are compiled and loaded)."""

from .conv_norm_act import (conv_band, conv_band_plain, conv_norm_act,
                            conv_norm_act_band, conv_norm_act_plain,
                            nchw_to_nhwc, nchw_to_nhwc_plain)
from .convt_norm_act import (convt_band, convt_band_plain, convt_norm_act,
                             convt_norm_act_band, convt_norm_act_plain,
                             pack_convt_weight, pack_convt_weight_nhwc,
                             pack_convt_weight_nhwc_plain,
                             pack_convt_weight_plain)
from .norm_act import (in_apply, in_apply_plain, in_bwd_apply,
                       in_bwd_apply_plain, in_bwd_sums, in_bwd_sums_plain,
                       in_stats, in_stats_plain, instance_norm_act,
                       instance_norm_act_backward,
                       instance_norm_act_backward_plain,
                       instance_norm_act_band, instance_norm_act_plain)
from .thin_conv import (pack_thin_weight, pack_thin_weight_plain,
                        thin_conv3x3, thin_conv3x3_plain, thin_conv3x3_wgrad,
                        thin_conv3x3_wgrad_plain)

# every kernel wrapper; each carries a ``launches`` count
WRAPPERS = (instance_norm_act, conv_norm_act, convt_norm_act,
            instance_norm_act_backward, thin_conv3x3, thin_conv3x3_wgrad)
# the band forms' wrappers (spatial parallelism), likewise counted
BAND_WRAPPERS = (in_stats, in_apply, conv_band, convt_band, in_bwd_sums,
                 in_bwd_apply)

__all__ = ['conv_band', 'conv_band_plain', 'conv_norm_act',
           'conv_norm_act_band', 'conv_norm_act_plain', 'convt_band',
           'convt_band_plain', 'convt_norm_act', 'convt_norm_act_band',
           'convt_norm_act_plain', 'in_apply', 'in_apply_plain',
           'in_bwd_apply', 'in_bwd_apply_plain', 'in_bwd_sums',
           'in_bwd_sums_plain', 'in_stats', 'in_stats_plain',
           'instance_norm_act', 'instance_norm_act_backward',
           'instance_norm_act_backward_plain', 'instance_norm_act_band',
           'instance_norm_act_plain', 'nchw_to_nhwc', 'nchw_to_nhwc_plain',
           'pack_convt_weight',
           'pack_convt_weight_nhwc', 'pack_convt_weight_nhwc_plain',
           'pack_convt_weight_plain', 'pack_thin_weight',
           'pack_thin_weight_plain', 'thin_conv3x3', 'thin_conv3x3_plain',
           'thin_conv3x3_wgrad', 'thin_conv3x3_wgrad_plain', 'WRAPPERS',
           'BAND_WRAPPERS']
