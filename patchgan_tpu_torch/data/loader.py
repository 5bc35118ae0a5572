"""Input pipeline: thread-pool host decode -> pinned host batch -> the
card, where it is normalised, one-hot encoded and flipped.

Port of the single-process part of ``patchgan_tpu/data/loader.py``:

- the batch order comes from ``np.random.default_rng(seed)``, shuffled
  once per epoch exactly as ``loader.py:237-256`` does, so both packages
  see the same batches from the same seed;
- a thread pool decodes (``num_workers``; 0 decodes in the producer
  thread) into a bounded prefetch queue;
- datasets with ``load_raw`` (or ``load_raw_u8``) ship uint8 or float
  images and integer labelmaps; the batch is pinned and copied to the
  device with ``non_blocking``, and the normalise / one-hot / flip
  (p = 0.25 horizontal and vertical, only for 'randomcrop+flip',
  ``loader.py:65-87, 354-355``) run there, the flips drawn from an
  explicit ``torch.Generator`` seeded with ``seed``;
- other datasets' ``__getitem__`` pairs (image, one-hot mask) are
  stacked and copied as they are.

Batches are NCHW. The process pool, the RAM cache, ``fast_forward`` /
``skip_next`` and per-host slicing are not ported and raise.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1 item 6)"


class _SyncPool:
    """num_workers=0: decode inline in the producer thread."""

    def map(self, fn, iterable):
        return [fn(i) for i in iterable]

    def shutdown(self, wait=False):
        pass


def augment_batch(images, labelmaps, labels, generator=None, flip=False,
                  dtype=torch.float32):
    """images: (N, H, W, C) uint8 or float in [0, 1]; labelmaps: (N, H, W)
    integers; labels: (L,) integers in the labelmaps' encoding, all on
    one device. Returns NCHW (x, y): x in ``dtype`` (uint8 divided by 255
    in it), y the one-hot over ``labels``, both flipped alike."""
    x = images.permute(0, 3, 1, 2).to(dtype)
    if images.dtype == torch.uint8:
        x = x / torch.tensor(255.0, dtype=dtype, device=x.device)
    y = (labelmaps.long()[:, None] == labels.view(1, -1, 1, 1)).to(dtype)
    if flip:
        n = x.shape[0]
        hflip, vflip = (torch.rand((n, 1, 1, 1), generator=generator,
                                   device=x.device) < 0.25
                        for _ in range(2))
        x = torch.where(hflip, x.flip(3), x)
        y = torch.where(hflip, y.flip(3), y)
        x = torch.where(vflip, x.flip(2), x)
        y = torch.where(vflip, y.flip(2), y)
    return x.contiguous(), y.contiguous()


class DataLoader:
    """Shuffling, batching, prefetching loader yielding (x, y) NCHW
    batches on ``device``."""

    def __init__(self, dataset, batch_size=16, shuffle=True,
                 drop_last=True, num_workers=4, prefetch=2, device='cpu',
                 dtype=torch.float32, seed=0, cache=False,
                 worker_type='thread'):
        if cache:
            raise NotImplementedError(f"the decoded-image cache "
                                      f"(dataset.cache) {_NOT_PORTED}")
        if worker_type != 'thread':
            raise NotImplementedError(
                f"worker_type {worker_type!r} {_NOT_PORTED}; use 'thread'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle_enabled = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.prefetch = prefetch
        self.device = torch.device(device)
        self.dtype = dtype
        self._rng = np.random.default_rng(seed)
        self._flip_gen = torch.Generator(device=self.device).manual_seed(
            seed)
        self.device_augment = hasattr(dataset, 'load_raw')

    def __len__(self):
        full, rem = divmod(len(self.dataset), self.batch_size)
        return full + (1 if rem and not self.drop_last else 0)

    def shuffle(self):
        """The Trainer's per-epoch hook; shuffling happens in
        ``__iter__``."""

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle_enabled:
            self._rng.shuffle(idx)
        bs = self.batch_size
        batches = [idx[i * bs:(i + 1) * bs] for i in range(len(idx) // bs)]
        rem = len(idx) % bs
        if rem and not self.drop_last:
            batches.append(idx[-rem:])
        return batches

    def _host_batch(self, pool, indices):
        """Decode one batch into two stacked host arrays, pinned when the
        device is a card."""
        if self.device_augment:
            fn = getattr(self.dataset, 'load_raw_u8', None) or \
                self.dataset.load_raw
        else:
            fn = self.dataset.__getitem__
        pairs = list(pool.map(fn, [int(i) for i in indices]))
        out = tuple(torch.from_numpy(np.stack([p[k] for p in pairs]))
                    for k in (0, 1))
        if self.device.type == 'cuda':
            out = tuple(t.pin_memory() for t in out)
        return out

    def _to_device(self, batch, labels, flip):
        a, b = (t.to(self.device, non_blocking=True) for t in batch)
        if self.device_augment:
            return augment_batch(a, b, labels, self._flip_gen, flip,
                                 self.dtype)
        return a.permute(0, 3, 1, 2).contiguous(), \
            b.permute(0, 3, 1, 2).contiguous()

    def __iter__(self):
        batches = self._index_batches()
        flip = self.device_augment and \
            getattr(self.dataset, 'augmentation', None) == 'randomcrop+flip'
        labels = None
        if self.device_augment:
            labels = np.asarray(self.dataset.labels, dtype=np.int64)
            if getattr(self.dataset, 'load_raw_u8', None) is not None:
                # the uint8 path ships RAW labelmaps (no +1 offset)
                labels = labels - 1
            labels = torch.from_numpy(labels).to(self.device)

        out_q = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        pool = _SyncPool() if self.num_workers == 0 else \
            ThreadPoolExecutor(max_workers=self.num_workers)

        def put(item):
            # bounded put that gives up once the consumer has stopped
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for indices in batches:
                    if stop.is_set() or not put(self._host_batch(
                            pool, indices)):
                        return
            except Exception as e:  # surfaced to the consumer
                put(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield self._to_device(item, labels, flip)
        finally:
            stop.set()
            pool.shutdown(wait=False)
