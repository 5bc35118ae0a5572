from .blocks import DownBlock, UpBlock
from .unet import UNet

__all__ = ['UNet', 'DownBlock', 'UpBlock']
