from .coco import COCOStuffDataset
from .plugin import load_dataset_class

__all__ = ['COCOStuffDataset', 'load_dataset_class']
