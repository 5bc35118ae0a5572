"""Activation vocabulary of the generator, over NCHW tensors.

Port of ``patchgan_tpu/ops/activations.py``: the same names, with
'softmax' over the channel axis (dim 1 in NCHW, the JAX package's last
axis in NHWC). 'leakyrelu' is written as ``jax.nn.leaky_relu`` is,
``where(x >= 0, x, 0.2 x)``, so its gradient at exactly 0 is 1 as in the
JAX package (autograd of ``F.leaky_relu`` gives 0.2 there).
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
        return torch.softmax(x, dim=1)
    if name == 'sigmoid':
        return torch.sigmoid(x)
    raise ValueError(f"Unknown activation: {name!r}")
