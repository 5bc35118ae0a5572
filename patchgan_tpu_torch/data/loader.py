"""Input pipeline: host decode (threads or processes, an optional RAM
cache) -> pinned host batch -> the card, where it is normalised, one-hot
encoded and flipped.

Port of ``patchgan_tpu/data/loader.py``:

- the batch order comes from ``np.random.default_rng(seed)``, shuffled
  once per epoch exactly as ``loader.py:237-256`` does, so both packages
  see the same batches from the same seed; ``fast_forward(n)`` consumes
  that generator as ``n`` epochs would, without decoding, and
  ``skip_next(n)`` leaves out the first ``n`` batches of the next epoch
  before they are decoded (``:215-236``): exact mid-epoch resume;
- ``num_workers`` decode threads (0 decodes in the producer thread), or
  with ``worker_type='process'`` a persistent forkserver process pool
  that receives the dataset once, through its initializer
  (``:301-325``); ``close()`` stops it;
- ``cache=True`` keeps every decoded pair in RAM (an int caps it at that
  many bytes, inserting no more once full), so later epochs decode
  nothing (``:163-174, 263-279``);
- datasets with ``load_raw`` (or ``load_raw_u8``) ship uint8 or float
  images and integer labelmaps; the batch is pinned and copied to the
  device with ``non_blocking``, and the normalise / one-hot / flip
  (p = 0.25 horizontal and vertical, only for 'randomcrop+flip',
  ``:65-87, 354-355``) run there. Each batch's flips come from a
  generator seeded with ``SeedSequence((seed, epoch, batch index))``, so
  a skipped prefix leaves the later batches' flips as they were (the
  JAX loader folds the batch index into its key, ``:375-376``, for the
  same reason; the two packages' draws differ);
- other datasets' ``__getitem__`` pairs (image, one-hot mask) are
  stacked and copied as they are.

Batches are NCHW. Per-rank slicing (``process_index`` /
``process_count``, ``:121-150, 177-253, 356-420``): ``batch_size`` is
the global batch, and each rank decodes only its
``process_local_range`` rows of every global batch. The shuffle order,
``fast_forward`` and ``skip_next`` are the same on every rank; each
batch's flips are drawn for the global batch and the rank keeps its
rows, so the ranks' batches, concatenated, are one process's batch bit
for bit. A remainder batch (``drop_last=False``) is kept only when it
divides across the ranks, and otherwise dropped, with one printed line.
"""

import pickle
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from ..parallel.multihost import process_local_range

# a process worker holds the dataset as a global, set once by the pool's
# initializer
_WORKER_DS = None


def _init_worker(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _worker_load_raw(index):
    return _raw_fn(_WORKER_DS)(index)


def _worker_getitem(index):
    return _WORKER_DS[index]


def _raw_fn(dataset):
    """The uint8 decode where the dataset has one, else ``load_raw``."""
    return getattr(dataset, 'load_raw_u8', None) or dataset.load_raw


class _SyncPool:
    """num_workers=0: decode inline in the producer thread."""

    def map(self, fn, iterable):
        return [fn(i) for i in iterable]

    def shutdown(self, wait=False):
        pass


def flip_seed(seed, epoch, batch_index):
    """The seed of one batch's flip draws: a function of (seed, epoch,
    batch index) alone."""
    return int(np.random.SeedSequence((seed, epoch, batch_index))
               .generate_state(1, np.uint64)[0])


def augment_batch(images, labelmaps, labels, generator=None, flip=False,
                  dtype=torch.float32, rows=None):
    """images: (N, H, W, C) uint8 or float in [0, 1]; labelmaps: (N, H, W)
    integers; labels: (L,) integers in the labelmaps' encoding, all on
    one device. Returns NCHW (x, y): x in ``dtype`` (uint8 divided by 255
    in it), y the one-hot over ``labels``, both flipped alike. ``rows``
    = (start, global batch): the N samples are these rows of a global
    batch, whose flips are drawn in full."""
    x = images.permute(0, 3, 1, 2).to(dtype)
    if images.dtype == torch.uint8:
        x = x / torch.tensor(255.0, dtype=dtype, device=x.device)
    y = (labelmaps.long()[:, None] == labels.view(1, -1, 1, 1)).to(dtype)
    if flip:
        n = x.shape[0]
        lo, total = rows or (0, n)
        hflip, vflip = (torch.rand((total, 1, 1, 1), generator=generator,
                                   device=x.device)[lo:lo + n] < 0.25
                        for _ in range(2))
        x = torch.where(hflip, x.flip(3), x)
        y = torch.where(hflip, y.flip(3), y)
        x = torch.where(vflip, x.flip(2), x)
        y = torch.where(vflip, y.flip(2), y)
    return x.contiguous(), y.contiguous()


class DataLoader:
    """Shuffling, batching, prefetching loader yielding (x, y) NCHW
    batches on ``device``. ``epoch`` counts the iterations begun (and
    the epochs ``fast_forward`` passed over)."""

    def __init__(self, dataset, batch_size=16, shuffle=True,
                 drop_last=True, num_workers=4, prefetch=2, device='cpu',
                 dtype=torch.float32, seed=0, cache=False,
                 worker_type='thread', process_index=None,
                 process_count=None):
        if process_count and process_count > 1 and process_index is None:
            # defaulting to 0 would decode rank 0's rows on every rank
            raise ValueError("process_index is required when "
                             "process_count > 1 is given")
        if process_count and batch_size % process_count:
            raise ValueError(f"batch {batch_size} must divide across "
                             f"{process_count} hosts")
        if worker_type not in ('thread', 'process'):
            raise ValueError(f"worker_type {worker_type!r} not in "
                             "('thread', 'process')")
        if worker_type == 'process' and num_workers <= 0:
            raise ValueError("num_workers=0 (synchronous decode) requires "
                             "worker_type='thread'")
        if worker_type == 'process' and cache:
            raise ValueError("the decoded-image RAM cache lives in the "
                             "parent process; use worker_type='thread' "
                             "with cache")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle_enabled = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.prefetch = prefetch
        self.device = torch.device(device)
        self.dtype = dtype
        self.worker_type = worker_type
        self.process_count = process_count
        self.process_index = process_index or 0
        self._warned_remainder = False
        self.seed = seed
        self.epoch = 0
        self._rng = np.random.default_rng(seed)
        self._skip_next = 0
        self._flip_gen = torch.Generator(device=self.device)
        self.device_augment = hasattr(dataset, 'load_raw')
        self._cache = {} if cache else None
        self._cache_budget = cache if isinstance(cache, int) and \
            not isinstance(cache, bool) else None
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()
        self._proc_pool = None

    def __len__(self):
        full, rem = divmod(len(self.dataset), self.batch_size)
        keep = rem and not self.drop_last and \
            rem % (self.process_count or 1) == 0
        return full + (1 if keep else 0)

    def shuffle(self):
        """The Trainer's per-epoch hook; shuffling happens in
        ``__iter__``."""

    def fast_forward(self, n_epochs):
        """Advance the epoch counter and the shuffle generator as
        ``n_epochs`` iterations would, decoding nothing: the next
        iteration gives the batches (and flips) of epoch
        ``epoch + n_epochs + 1`` of an uninterrupted run."""
        for _ in range(int(n_epochs)):
            self.epoch += 1
            if self.shuffle_enabled:
                self._rng.shuffle(np.arange(len(self.dataset)))

    def skip_next(self, n_batches):
        """Leave out the first ``n_batches`` of the next iteration, before
        they are decoded. The later batches keep their indices, and so
        their flips: the rest of the epoch is the uninterrupted one's."""
        self._skip_next = int(n_batches)

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle_enabled:
            self._rng.shuffle(idx)
        bs = self.batch_size
        batches = [idx[i * bs:(i + 1) * bs] for i in range(len(idx) // bs)]
        rem = len(idx) % bs
        if rem and not self.drop_last:
            divisor = self.process_count or 1
            if rem % divisor == 0:
                batches.append(idx[-rem:])
            elif not self._warned_remainder:
                print(f"DataLoader: dropping the {rem}-sample remainder "
                      f"batch each epoch (not divisible by {divisor} "
                      f"ranks)")
                self._warned_remainder = True
        return batches

    def _local(self, indices):
        """(this rank's indices of a global batch, (start, global
        size))."""
        if not self.process_count:
            return indices, (0, len(indices))
        lo, hi = process_local_range(len(indices), self.process_index,
                                     self.process_count)
        return indices[lo:hi], (lo, len(indices))

    def _load_raw_cached(self, index):
        hit = self._cache.get(index)
        if hit is not None:
            return hit
        pair = _raw_fn(self.dataset)(index)
        nbytes = pair[0].nbytes + pair[1].nbytes
        # a racing second decode of one index is harmless; the budget's
        # check and the insert are one step, so racing misses cannot
        # overshoot it
        with self._cache_lock:
            if index not in self._cache and (
                    self._cache_budget is None or
                    self._cache_bytes + nbytes <= self._cache_budget):
                self._cache[index] = pair
                self._cache_bytes += nbytes
        return pair

    def _decode_fn(self):
        if self.worker_type == 'process':
            return _worker_load_raw if self.device_augment \
                else _worker_getitem
        if not self.device_augment:
            return self.dataset.__getitem__
        if self._cache is not None:
            return self._load_raw_cached
        return _raw_fn(self.dataset)

    def _process_pool(self):
        """The persistent forkserver pool: workers fork from a clean
        server process, not from this threaded one, and get the dataset
        once, through the initializer, for the loader's lifetime."""
        if self._proc_pool is None:
            try:
                pickle.dumps(self.dataset)
            except (pickle.PicklingError, AttributeError, TypeError) as e:
                raise ValueError(
                    f"worker_type='process' sends the dataset to each "
                    f"worker by pickle, and "
                    f"{type(self.dataset).__module__}."
                    f"{type(self.dataset).__qualname__} does not pickle "
                    f"({e}); a class from a cwd io.py plugin cannot be "
                    f"imported by a worker. Use worker_type='thread'.") \
                    from e
            import multiprocessing
            self._proc_pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context('forkserver'),
                initializer=_init_worker, initargs=(self.dataset,))
        return self._proc_pool

    def close(self, wait=True):
        """Stop the process workers (they persist across epochs)."""
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=wait, cancel_futures=True)
            self._proc_pool = None

    def __del__(self):
        try:
            self.close(wait=False)
        except Exception:
            pass

    def _host_batch(self, pool, fn, indices):
        """Decode one batch into two stacked host arrays, pinned when the
        device is a card."""
        pairs = list(pool.map(fn, [int(i) for i in indices]))
        out = tuple(torch.from_numpy(np.stack([p[k] for p in pairs]))
                    for k in (0, 1))
        if self.device.type == 'cuda':
            out = tuple(t.pin_memory() for t in out)
        return out

    def _to_device(self, batch, labels, flip, epoch, bi, rows):
        a, b = (t.to(self.device, non_blocking=True) for t in batch)
        if self.device_augment:
            if flip:
                self._flip_gen.manual_seed(flip_seed(self.seed, epoch, bi))
            return augment_batch(a, b, labels, self._flip_gen, flip,
                                 self.dtype, rows)
        return a.permute(0, 3, 1, 2).contiguous(), \
            b.permute(0, 3, 1, 2).contiguous()

    def __iter__(self):
        self.epoch += 1
        epoch = self.epoch
        batches = self._index_batches()
        skip, self._skip_next = self._skip_next, 0
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
        if self.worker_type == 'process':
            pool = self._process_pool()
        elif self.num_workers == 0:
            pool = _SyncPool()
        else:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
        fn = self._decode_fn()

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
                for bi in range(skip, len(batches)):
                    indices, rows = self._local(batches[bi])
                    if stop.is_set() or not put(
                            (bi, rows, self._host_batch(pool, fn, indices))):
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
                bi, rows, batch = item
                yield self._to_device(batch, labels, flip, epoch, bi, rows)
        finally:
            stop.set()
            if pool is not self._proc_pool:
                # thread pools live for one epoch, the process pool for
                # the loader
                pool.shutdown(wait=False)
