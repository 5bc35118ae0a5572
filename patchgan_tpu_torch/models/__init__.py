from .blocks import DownBlock, UpBlock
from .disc import Discriminator
from .unet import UNet

__all__ = ['UNet', 'DownBlock', 'UpBlock', 'Discriminator']
