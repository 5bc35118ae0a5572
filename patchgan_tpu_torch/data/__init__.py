from .coco import COCOStuffDataset
from .loader import DataLoader
from .plugin import load_dataset_class
from .shards import TarShardDataset

__all__ = ['COCOStuffDataset', 'DataLoader', 'load_dataset_class',
           'TarShardDataset']
