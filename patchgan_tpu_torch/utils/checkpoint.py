"""npz / .pth checkpoint files keyed by torch state_dict names, and the
epoch-numbered checkpoint store.

Port of ``patchgan_tpu/utils/checkpoint.py``: an ``.npz`` whose keys are
the reference's state_dict names and whose arrays are in torch layouts,
so the JAX package and this port read each other's files; two files per
epoch, ``generator_ep_{epoch:03d}`` and ``discriminator_ep_{epoch:03d}``,
resumed from the largest epoch of the union of both.
"""

import glob
import os
import re

import numpy as np
import torch

GEN_PREFIX = 'generator_ep_'
DISC_PREFIX = 'discriminator_ep_'


def save_state_dict(path, state_dict):
    """An npz of the state_dict's tensors as fp32 in NCHW (C) order,
    whatever their layout (a channels_last parameter included)."""
    np.savez(path, **{k: v.detach().float().cpu().contiguous().numpy()
                      if isinstance(v, torch.Tensor) else np.asarray(v)
                      for k, v in state_dict.items()})


def load_state_dict(path):
    """Load a checkpoint into {key: CPU tensor}: our ``.npz`` format, or
    a torch ``.pth`` / ``.pt`` file (tensors only)."""
    if path.endswith('.pth') or path.endswith('.pt'):
        state = torch.load(path, map_location='cpu', weights_only=True)
        return {k: v for k, v in state.items()
                if isinstance(v, torch.Tensor)}
    with np.load(path) as data:
        return {k: torch.from_numpy(data[k]) for k in data.files}


def checkpoint_epochs(savefolder, prefix):
    """{epoch: path} of the files of ``prefix`` (.npz, .pth or .pt)."""
    epochs = {}
    for path in glob.glob(os.path.join(savefolder, f'{prefix}*')):
        m = re.match(rf'{re.escape(prefix)}(\d+)\.(npz|pth|pt)$',
                     os.path.basename(path))
        if m:
            epochs[int(m.group(1))] = path
    return epochs


def find_last_checkpoint(savefolder):
    """(epoch, generator path, discriminator path) of the latest epoch:
    the largest over the union of both prefixes; a missing counterpart
    raises (KeyError), as in the JAX package."""
    gen = checkpoint_epochs(savefolder, GEN_PREFIX)
    disc = checkpoint_epochs(savefolder, DISC_PREFIX)
    if not gen:
        raise FileNotFoundError("No checkpoints found!")
    last = max(set(gen) | set(disc))
    return last, gen[last], disc[last]
