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


def state_dict_from_jax(params, n_levels=7):
    """JAX UNet parameter tree ({'enc{i}': {'kernel': HWIO}, 'dec{i}':
    {'kernel': pre-flipped HWIO}}, numpy arrays) -> the port's state_dict.

    The inverse of the JAX package's ``conv_kernel_to_jax`` (OIHW ->
    HWIO) and ``convT_kernel_to_jax`` (IOHW -> spatially flipped HWIO)."""
    out = {}
    for i in range(n_levels):
        w = np.asarray(params[f'enc{i}']['kernel'])
        out[f'encoder.{i}.model.DownConv{i}.weight'] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
    for i in range(n_levels):
        w = np.transpose(np.asarray(params[f'dec{i}']['kernel']),
                         (2, 3, 0, 1))[:, :, ::-1, ::-1]
        out[f'decoder.{i}.model.UpConv{i}.weight'] = torch.from_numpy(
            np.ascontiguousarray(w))
    return out
