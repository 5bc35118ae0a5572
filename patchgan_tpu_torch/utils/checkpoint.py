"""npz / .pth checkpoint files keyed by torch state_dict names.

Port of ``patchgan_tpu/utils/checkpoint.py:24-35``: an ``.npz`` whose
keys are the reference's state_dict names and whose arrays are in torch
layouts, so the JAX package and this port read each other's files.
"""

import numpy as np
import torch


def save_state_dict(path, state_dict):
    np.savez(path, **{k: v.detach().float().cpu().numpy()
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
