"""Checkpoint transfer: shape-matched loading, and the JAX parameter tree
-> state_dict conversion.

Port of ``patchgan_tpu/utils/transfer.py``. The port's modules use the
reference's state_dict keys and torch layouts (OIHW conv weights,
unflipped IOHW transposed-conv weights), so an npz checkpoint written by
either package loads into the other with no mapping.
"""

import numpy as np
import torch


class InvalidCheckpointError(Exception):
    pass


def unet_key_map(n_levels=7):
    """The U-Net generator's state_dict keys: 7 encoder DownConv and 7
    decoder UpConv weights."""
    return ([f'encoder.{i}.model.DownConv{i}.weight'
             for i in range(n_levels)]
            + [f'decoder.{i}.model.UpConv{i}.weight'
               for i in range(n_levels)])


def unet_jax_path(key):
    """The JAX parameter path of a generator state_dict key, as the JAX
    package's freeze patterns match it: 'enc{i}/kernel' for
    ``encoder.{i}.model.DownConv{i}.weight``, 'dec{i}/kernel' for
    ``decoder.{i}.model.UpConv{i}.weight``."""
    part, level = key.split('.')[:2]
    return f"{part[:3]}{level}/kernel"


def disc_key_map(n_layers=3, norm=False):
    """The discriminator's state_dict keys, by JAX parameter name:
    {'conv0_kernel': 'model.0.weight', ...}. The Sequential indices follow
    the reference's layer list (conv, activation, optional norm), as
    ``patchgan_tpu/utils/transfer.py:74-99`` counts them."""
    keys = {}
    idx = 0

    def add(name, has_bias, width):
        keys[f'{name}_kernel'] = f'model.{idx}.weight'
        if has_bias:
            keys[f'{name}_bias'] = f'model.{idx}.bias'
        return idx + width

    idx = add('conv0', True, 2)           # conv + leakyrelu
    for n in range(1, n_layers):
        idx = add(f'conv{n}', False, 3 if norm else 2)
    idx = add(f'conv{n_layers}', False, 3 if norm else 2)
    add('conv_out', True, 1)
    return keys


def load_transfer_data(module, state_dict, verbose=True):
    """Copy every tensor of ``state_dict`` whose key exists in
    ``module.state_dict()`` with the same shape; return the count. Raises
    InvalidCheckpointError when nothing could be copied."""
    own = module.state_dict()
    count = 0
    with torch.no_grad():
        for key, value in state_dict.items():
            target = own.get(key)
            if target is None:
                continue
            value = torch.as_tensor(np.asarray(value)) \
                if not isinstance(value, torch.Tensor) else value
            if tuple(value.shape) == tuple(target.shape):
                target.copy_(value.to(target.dtype))
                count += 1
    if count == 0:
        raise InvalidCheckpointError("Could not load transfer weights")
    if verbose:
        print(f"Loaded {count} weights out of {len(state_dict)}")
    return count


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w), (3, 2, 0, 1))))


def state_dict_from_jax(params, n_levels=7, norm=False):
    """JAX parameter tree (numpy arrays) -> the port's state_dict.

    A UNet tree ({'enc{i}': {'kernel': HWIO}, 'dec{i}': {'kernel':
    pre-flipped HWIO}}) or a Discriminator tree ({'conv{n}_kernel': HWIO,
    'conv0_bias', 'conv_out_kernel', 'conv_out_bias'}; ``norm`` is the
    discriminator's, which shifts the Sequential indices). The inverse of
    the JAX package's ``conv_kernel_to_jax`` (OIHW -> HWIO) and
    ``convT_kernel_to_jax`` (IOHW -> spatially flipped HWIO)."""
    if 'conv0_kernel' in params:
        n_layers = sum(1 for k in params if k.startswith('conv')
                       and k.endswith('_kernel')) - 2
        out = {}
        for name, key in disc_key_map(n_layers, norm).items():
            v = params[name]
            out[key] = _oihw(v) if name.endswith('_kernel') else \
                torch.from_numpy(np.array(v))
        return out
    out = {}
    for i in range(n_levels):
        out[f'encoder.{i}.model.DownConv{i}.weight'] = _oihw(
            params[f'enc{i}']['kernel'])
    for i in range(n_levels):
        w = np.transpose(np.asarray(params[f'dec{i}']['kernel']),
                         (2, 3, 0, 1))[:, :, ::-1, ::-1]
        out[f'decoder.{i}.model.UpConv{i}.weight'] = torch.from_numpy(
            np.ascontiguousarray(w))
    return out
