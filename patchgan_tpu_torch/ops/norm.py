"""Affine-free instance normalisation with a fused activation, NCHW.

Port of ``patchgan_tpu/ops/norm.py`` (``_instance_norm_xla`` :33-43 and
``instance_norm`` :108-130): ``instance_norm(x, eps=1e-5,
activation=None)`` with torch ``InstanceNorm2d`` defaults (biased
variance), statistics always in fp32 with var = E[x^2] - mean^2,
normalised in fp32, then cast back. It is kernel K1's wrapper: a CUDA
tensor runs the kernel (``ops/kernels/norm_act.py``), a CPU tensor its
plain version. Under autograd it goes through ``InstanceNormAct``, the
custom-backward form of ``ops/norm.py:70-105``: the only residual is x,
and the backward (kernel K1-bwd on the card) recomputes the statistics.
"""

from .kernels.norm_act import instance_norm_act as instance_norm

__all__ = ['instance_norm']
