"""WebDataset-style tar-shard input: a drop-in for ``COCOStuffDataset``.

Port of ``patchgan_tpu/data/shards.py``. Listing tar shards costs
O(shards) instead of O(files), and object stores serve large sequential
reads far better than many small files. Same constructor shape, labels /
one-hot semantics, loader protocol (``load_raw_u8`` / ``load_raw``) and
inference protocol (``get_filename`` / ``save_mask`` / ``get_image``) as
the folder dataset.

Shard format: each shard is an (optionally gzip'd) ``.tar`` whose
members pair ``<id>.jpg`` (RGB image) with ``<id>.png`` (grayscale
labelmap), in any member order. ``<id>`` is the member path minus
extension (webdataset semantics: basename-only keys would silently
collide across subdirectories); a split layout like ``images/0001.jpg``
+ ``masks/0001.png`` is also accepted, resolved by unique basename
(ambiguous basenames raise). Masks may be absent for inference-only
shards. Pairs are ordered by (shard path, member path), so the epoch
order is deterministic. Members decode with PIL from their bytes, as in
the JAX package.
"""

import glob as _glob
import io
import os
import tarfile
import threading

import numpy as np

from .coco import COCOStuffDataset

__all__ = ['TarShardDataset']


def _stem(name):
    # full path minus extension: basename-only keys silently collide
    # across subdirectories within one tar (a/0001.jpg vs b/0001.jpg),
    # dropping an image or pairing a mask with the wrong one
    return os.path.splitext(name)[0]


# per-thread open tar handle budget: unbounded caching accumulates
# shards x workers descriptors over a long run and can hit the fd limit
_MAX_OPEN_TARS = 8


class TarShardDataset:
    augmentation = None

    def __init__(self, shards, maskfolder=None, labels=(1,), size=256,
                 augmentation='resize'):
        """``shards``: a tar path, a glob pattern, or a list of tar
        paths. ``maskfolder`` is accepted for dataset-factory signature
        compatibility (cli/common.py) and ignored -- masks live inside
        the shards."""
        if isinstance(shards, str):
            paths = sorted(_glob.glob(shards)) \
                if any(c in shards for c in '*?[') else [shards]
        else:
            paths = sorted(shards)
        if not paths:
            raise FileNotFoundError(f"No tar shards match {shards!r}")
        self.shards = paths
        self.size = size
        self.labels = np.sort(np.asarray(labels))
        self.augmentation = augmentation

        # index pass: tar headers only, one sequential scan per shard
        self._index = []  # (shard_i, jpg_member, png_member_or_None)
        for si, path in enumerate(paths):
            with tarfile.open(path) as tf:
                names = [m.name for m in tf.getmembers() if m.isfile()]
            jpgs, pngs = {}, {}
            for n in names:
                lower = n.lower()
                table = jpgs if lower.endswith(('.jpg', '.jpeg')) else \
                    pngs if lower.endswith('.png') else None
                if table is None:
                    continue
                stem = _stem(n)
                if stem in table:
                    raise ValueError(
                        f"duplicate member stem {stem!r} in shard "
                        f"{path!r}: {table[stem]!r} vs {n!r}")
                table[stem] = n
            # split layouts (images/0001.jpg + masks/0001.png) have no
            # full-path match: resolve leftover masks by UNIQUE
            # basename; ambiguous basenames raise rather than mispair
            unmatched = {s: n for s, n in pngs.items() if s not in jpgs}
            by_base = {}
            for s, n in unmatched.items():
                by_base.setdefault(os.path.basename(s), []).append(n)
            fallback_jpg_bases = [os.path.basename(s) for s in jpgs
                                  if s not in pngs]
            for stem in sorted(jpgs):
                png = pngs.get(stem)
                if png is None and unmatched:
                    base = os.path.basename(stem)
                    cands = by_base.get(base, [])
                    if cands and (len(cands) > 1
                                  or fallback_jpg_bases.count(base) > 1):
                        raise ValueError(
                            f"ambiguous mask basename for {jpgs[stem]!r}"
                            f" in shard {path!r}: images "
                            f"{[n for s, n in jpgs.items() if os.path.basename(s) == base]!r}"
                            f" vs masks {sorted(cands)!r}")
                    if cands:
                        png = cands[0]
                self._index.append((si, jpgs[stem], png))
        self._local = threading.local()  # per-thread open tar handles
        print(f"Loaded {len(self)} images from {len(paths)} shards")

    # tar handles are neither thread-safe nor picklable: keep one per
    # worker thread, drop them when the dataset ships to a process pool
    def __getstate__(self):
        state = self.__dict__.copy()
        state['_local'] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local = threading.local()

    def _tar(self, shard_i):
        # small per-thread LRU of open handles (dict preserves insertion
        # order): sequential access touches one shard at a time, so a
        # handful of slots covers the common case while bounding fds
        handles = getattr(self._local, 'handles', None)
        if handles is None:
            handles = self._local.handles = {}
        tf = handles.pop(shard_i, None)
        if tf is None:
            tf = tarfile.open(self.shards[shard_i])
            while len(handles) >= _MAX_OPEN_TARS:
                lru_key = next(iter(handles))
                handles.pop(lru_key).close()
        handles[shard_i] = tf  # re-insert = move to MRU position
        return tf

    def _bytes(self, shard_i, member):
        return self._tar(shard_i).extractfile(member).read()

    def __len__(self):
        return len(self._index)

    # host decode path (the loader's protocol; data/coco.py's semantics,
    # the NEAREST mask resize included)
    def _resize_enabled(self):
        return self.augmentation in ('randomcrop', 'randomcrop+flip')

    def _flip_enabled(self):
        return self.augmentation == 'randomcrop+flip'

    def _decode_image_u8(self, shard_i, member, resize):
        from PIL import Image
        img = Image.open(io.BytesIO(self._bytes(shard_i, member))) \
            .convert('RGB')
        if resize:
            img = img.resize((self.size, self.size), Image.BILINEAR)
        return np.asarray(img, np.uint8)

    def _decode_mask_u8(self, shard_i, member, resize):
        from PIL import Image
        mask = Image.open(io.BytesIO(self._bytes(shard_i, member))) \
            .convert('L')
        if resize:
            mask = mask.resize((self.size, self.size), Image.NEAREST)
        return np.asarray(mask, np.uint8)

    def load_raw_u8(self, index):
        """(uint8 HWC image, uint8 HW RAW labelmap): the loader's uint8
        path (normalise / one-hot / flip run on the device; the label
        table is offset there, see loader.py)."""
        si, jpg, png = self._index[index]
        if png is None:
            raise KeyError(
                f"shard member {jpg!r} has no paired .png mask")
        resize = self._resize_enabled()
        return (self._decode_image_u8(si, jpg, resize),
                self._decode_mask_u8(si, png, resize))

    def load_raw(self, index):
        """(image HWC float32 in [0,1], labelmap HW int32 of PNG values
        + 1)."""
        image, labelmap = self.load_raw_u8(index)
        return (image.astype(np.float32) / 255.0,
                labelmap.astype(np.int32) + 1)

    def one_hot(self, labelmap):
        return (labelmap[:, :, None]
                == self.labels[None, None, :]).astype(np.float32)

    def __getitem__(self, index):
        """(image HWC float32, one-hot mask HWC float32), flipped on the
        host with p = 0.25 each way for 'randomcrop+flip', as
        data/coco.py's ``__getitem__``."""
        image, labelmap = self.load_raw(index)
        if self._flip_enabled():
            if np.random.uniform() < 0.25:
                image = image[:, ::-1]
                labelmap = labelmap[:, ::-1]
            if np.random.uniform() < 0.25:
                image = image[::-1]
                labelmap = labelmap[::-1]
        return np.ascontiguousarray(image), self.one_hot(
            np.ascontiguousarray(labelmap))

    # inference protocol
    def get_filename(self, index):
        return os.path.basename(self._index[index][1])

    save_mask = staticmethod(COCOStuffDataset.save_mask)

    def get_image(self, index):
        """HWC float32 in [0,1], original resolution (tiling handles
        arbitrary sizes), as the JAX dataset returns it."""
        si, jpg, _ = self._index[index]
        return (self._decode_image_u8(si, jpg, resize=False)
                .astype(np.float32) / 255.0)
