"""COCO-Stuff style dataset: ``*.jpg`` images and ``*.png`` masks with
matching integer basenames.

Port of ``patchgan_tpu/data/coco.py``: sorted globs with the integer-ID
check; images decode to RGB, /255 as floats (``load_raw``) or kept as
uint8 for the loader to normalise on the device (``load_raw_u8``);
mask labels are the PNG grey value + 1, one-hot over the sorted
``labels``; the augmentation vocabulary: 'randomcrop' resizes to
(size, size) (bilinear image, NEAREST mask), 'randomcrop+flip' resizes
and flips (on the device in the loader, on the host in
``__getitem__``), anything else ('resize', the default) leaves the
image as it is. Decoding goes through ``data/native.py`` (libjpeg /
libpng with a fused resize, as ``coco.py:74-96`` does; PIL where the
library is unavailable), so both packages decode a file to the same
pixels. ``get_filename``, ``get_image`` and ``save_mask`` serve
inference.
"""

import glob
import os

import numpy as np

from . import native


class COCOStuffDataset:
    augmentation = None

    def __init__(self, imgfolder, maskfolder=None, labels=(1,), size=256,
                 augmentation='resize'):
        if maskfolder is None:
            maskfolder = imgfolder
        self.images = sorted(glob.glob(os.path.join(imgfolder, '*.jpg')))
        self.masks = sorted(glob.glob(os.path.join(maskfolder, '*.png')))
        self.labels = np.sort(np.asarray(labels))
        self.size = size
        self.augmentation = augmentation

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

    def _resize_to(self):
        if self.augmentation in ('randomcrop', 'randomcrop+flip'):
            return self.size
        return None

    def load_raw(self, index):
        """(image HWC float32 in [0, 1], labelmap HW int32 = grey + 1)."""
        size = self._resize_to()
        return (native.decode_jpeg_rgb(self.images[index], size),
                native.decode_png_gray(self.masks[index], size) + 1)

    def load_raw_u8(self, index):
        """(image HWC uint8, labelmap HW uint8 WITHOUT the +1): a quarter
        of the float32 bytes over the host-to-device copy; the loader
        normalises and one-hots on the device."""
        size = self._resize_to()
        return (native.decode_jpeg_rgb_u8(self.images[index], size),
                native.decode_png_gray_u8(self.masks[index], size))

    def one_hot(self, labelmap):
        """(H, W) labelmap -> (H, W, n_labels) float32 one-hot."""
        return (labelmap[:, :, None]
                == self.labels[None, None, :]).astype(np.float32)

    def __getitem__(self, index):
        """(image HWC float32, one-hot mask HWC float32), flipped on the
        host with p = 0.25 each way for 'randomcrop+flip'."""
        image, labelmap = self.load_raw(index)
        if self.augmentation == 'randomcrop+flip':
            if np.random.uniform() < 0.25:
                image, labelmap = image[:, ::-1], labelmap[:, ::-1]
            if np.random.uniform() < 0.25:
                image, labelmap = image[::-1], labelmap[::-1]
        return np.ascontiguousarray(image), self.one_hot(
            np.ascontiguousarray(labelmap))

    def get_filename(self, index):
        return os.path.basename(self.images[index])

    def get_image(self, index):
        """HWC uint8 RGB at the original resolution."""
        return native.decode_jpeg_rgb_u8(self.images[index], None)

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
