"""Overlap tiling and mask stitching for arbitrary-size inference (HWC).

Port of ``patchgan_tpu/inference/tiling.py``, after the reference
tiler: crops of ``size`` x ``size`` at stride ``int(overlap * size)``
with the last row/column clamped to the image edge; stitching sums crop
predictions into a canvas with a hit count and divides, then optionally
binarises at ``threshold`` and arg-maxes over channels. Tiles are
linearised as ``j * ncropsx + i`` (the reference's ``j * ncropsy + i``
scrambled non-square images).
"""

import math

import numpy as np


def crop_positions(image_height, image_width, size, overlap):
    """Top-left (y, x) of every tile, row-major (y outer, x inner)."""
    effective = int(overlap * size)
    ncropsy = math.ceil(image_height / effective)
    ncropsx = math.ceil(image_width / effective)
    positions = []
    for j in range(ncropsy):
        for i in range(ncropsx):
            starty = j * effective
            startx = i * effective
            starty -= max(starty + size - image_height, 0)
            startx -= max(startx + size - image_width, 0)
            positions.append((starty, startx))
    return positions


def n_crop(image, size, overlap):
    """(H, W, C) image -> (N, size, size, C) stack of overlapping tiles."""
    h, w = image.shape[:2]
    positions = crop_positions(h, w, size, overlap)
    crops = np.empty((len(positions), size, size, image.shape[2]),
                     dtype=image.dtype)
    for n, (y, x) in enumerate(positions):
        crops[n] = image[y:y + size, x:x + size]
    return crops


def build_mask(masks, crop_size, image_size, threshold, overlap):
    """Stitch (N, size, size, C) tile predictions back to the image grid.

    Returns (H, W) argmax labels when C > 1, else the (H, W) channel-0
    map (thresholded to {0,1} when threshold > 0).
    """
    masks = np.asarray(masks, dtype=np.float32)
    c = masks.shape[-1]
    h, w = image_size
    canvas = np.zeros((h, w, c), dtype=np.float32)
    count = np.zeros((h, w, 1), dtype=np.float32)
    for n, (y, x) in enumerate(crop_positions(h, w, crop_size, overlap)):
        canvas[y:y + crop_size, x:x + crop_size] += masks[n]
        count[y:y + crop_size, x:x + crop_size] += 1.0
    canvas /= count

    if threshold > 0:
        canvas = np.where(canvas >= threshold, 1.0, 0.0)

    if c > 1:
        return np.argmax(canvas, axis=-1)
    return canvas[..., 0]
