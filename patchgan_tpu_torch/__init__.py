"""patchgan-tpu-torch: the PyTorch / CUDA port of ``patchgan_tpu``.

A U-Net segmentation generator trained adversarially against a
patch-wise discriminator, with tiled large-image inference, running on
an NVIDIA H100 with hand-written CUDA kernels for the fused instance
norm + activation (forward and backward), conv + norm + activation and
transposed conv + norm + activation levels. It imports nothing of the
JAX package; checkpoints (npz with torch state_dict keys) load into
either package.
"""

from .data import COCOStuffDataset, DataLoader
from .models import Discriminator, UNet
from .train import Trainer
from .utils.transfer import InvalidCheckpointError
from .version import __version__

__all__ = ['UNet', 'Discriminator', 'Trainer', 'DataLoader',
           'InvalidCheckpointError', 'COCOStuffDataset', '__version__']
