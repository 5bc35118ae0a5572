"""COCO-Stuff style dataset, inference subset: ``*.jpg`` images (and,
when present, ``*.png`` masks with matching integer basenames).

Port of the inference half of ``patchgan_tpu/data/coco.py``: sorted
globs with the integer-ID check, ``get_filename``, ``get_image`` (uint8
HWC at the original resolution; the engine divides by 255 on the device)
and ``save_mask``. Training's decode, resize and one-hot come with the
training slice.
"""

import glob
import os

import numpy as np


class COCOStuffDataset:
    def __init__(self, imgfolder, maskfolder=None, labels=(1,)):
        if maskfolder is None:
            maskfolder = imgfolder
        self.images = sorted(glob.glob(os.path.join(imgfolder, '*.jpg')))
        self.masks = sorted(glob.glob(os.path.join(maskfolder, '*.png')))
        self.labels = np.sort(np.asarray(labels))

        image_ids = [int(os.path.splitext(os.path.basename(p))[0])
                     for p in self.images]
        mask_ids = [int(os.path.splitext(os.path.basename(p))[0])
                    for p in self.masks]
        # masks may be absent for inference-only use
        if self.masks and image_ids != mask_ids:
            raise ValueError("Image IDs and Mask IDs do not match!")

        print(f"Loaded {len(self)} images")

    def __len__(self):
        return len(self.images)

    def get_filename(self, index):
        return os.path.basename(self.images[index])

    def get_image(self, index):
        """HWC uint8 RGB at the original resolution."""
        from PIL import Image
        with Image.open(self.images[index]) as im:
            return np.asarray(im.convert('RGB'), dtype=np.uint8)

    @staticmethod
    def save_mask(mask, output_path, fname):
        """Save a stitched prediction as PNG (uint8 label/probability
        map)."""
        from PIL import Image
        arr = np.asarray(mask)
        if arr.dtype in (np.float32, np.float64):
            arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8) \
                if arr.max() <= 1.0 else arr.astype(np.uint8)
        else:
            arr = arr.astype(np.uint8)
        Image.fromarray(arr).save(
            os.path.join(output_path, f'{fname}.png'))
