from .engine import InferenceEngine
from .tiling import build_mask, crop_positions, n_crop

__all__ = ['n_crop', 'build_mask', 'crop_positions', 'InferenceEngine']
