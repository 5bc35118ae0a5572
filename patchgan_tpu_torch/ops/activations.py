"""Activation vocabulary of the generator, over NCHW tensors.

Port of ``patchgan_tpu/ops/activations.py``: the same names, with
'softmax' over the channel axis (dim 1 in NCHW, the JAX package's last
axis in NHWC). 'leakyrelu' is written as ``jax.nn.leaky_relu`` is,
``where(x >= 0, x, 0.2 x)``, so its gradient at exactly 0 is 1 as in the
JAX package (autograd of ``F.leaky_relu`` gives 0.2 there).

Each keeps its input's layout: on a channels_last tensor the softmax runs
over the last axis of its NHWC view (contiguous there), since
``torch.softmax`` over dim 1 would first copy the tensor to NCHW.
"""

import torch
import torch.nn.functional as F


def apply_activation(x, name):
    if name is None or name == 'linear':
        return x
    if name == 'tanh':
        return torch.tanh(x)
    if name == 'relu':
        return F.relu(x)
    if name == 'leakyrelu':
        return torch.where(x >= 0, x, 0.2 * x)
    if name == 'softmax':
        if x.dim() == 4 and not x.is_contiguous() and \
                x.is_contiguous(memory_format=torch.channels_last):
            return torch.softmax(x.permute(0, 2, 3, 1), dim=-1) \
                .permute(0, 3, 1, 2)
        return torch.softmax(x, dim=1)
    if name == 'sigmoid':
        return torch.sigmoid(x)
    raise ValueError(f"Unknown activation: {name!r}")
