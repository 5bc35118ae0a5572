"""The port's input pipeline against the JAX package's: the native decode
gives the same pixels (and, with PATCHGAN_NATIVE_IO=off, the PIL paths
do), ``fast_forward`` / ``skip_next`` replay the JAX loader's order, a
skipped prefix leaves the later flips as they were, the RAM cache stops
decoding after the first epoch within its budget, and process workers
give the threads' batches."""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from patchgan_tpu.cli.serve import _decode as jax_serve_decode
from patchgan_tpu.data import DataLoader as JaxLoader
from patchgan_tpu.data import native as jax_native
from patchgan_tpu_torch.cli.serve import _decode as serve_decode
from patchgan_tpu_torch.data import COCOStuffDataset, DataLoader, native
from patchgan_tpu_torch.data.loader import flip_seed
from patchgan_tpu_torch.data.plugin import load_dataset_class

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def image_files(tmp_path):
    """A smooth 3-channel JPEG and a 3-label PNG, 45 x 70 (no square, no
    multiple of 8)."""
    rng = np.random.default_rng(60)
    yy, xx = np.mgrid[0:45, 0:70]
    img = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, (xx + yy * 2) % 256],
                   -1).astype(np.float64)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / 'a.jpg', quality=90)
    mask = rng.integers(0, 3, (45, 70)).astype(np.uint8)
    Image.fromarray(mask, mode='L').save(tmp_path / 'a.png')
    return str(tmp_path / 'a.jpg'), str(tmp_path / 'a.png')


@pytest.fixture
def coco_dir(tmp_path):
    imgdir, maskdir = tmp_path / 'images', tmp_path / 'masks'
    imgdir.mkdir()
    maskdir.mkdir()
    rng = np.random.default_rng(61)
    for i in range(10):
        img = (rng.uniform(size=(40, 56, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(imgdir / f'{i:012d}.jpg')
        mask = rng.integers(0, 3, size=(40, 56)).astype(np.uint8)
        Image.fromarray(mask, mode='L').save(maskdir / f'{i:012d}.png')
    return str(imgdir), str(maskdir)


@pytest.fixture
def npz_ds(tmp_path, monkeypatch):
    shutil.copy(os.path.join(ROOT, 'examples', 'io_plugin_example.py'),
                tmp_path / 'io.py')
    rng = np.random.default_rng(62)
    for i in range(11):
        np.savez(tmp_path / f'{i:03d}.npz',
                 image=rng.random((8, 12, 3), dtype=np.float32),
                 labels=rng.integers(1, 4, (8, 12)).astype(np.int32))
    monkeypatch.chdir(tmp_path)
    cls = load_dataset_class('NpzSegmentationDataset')
    return cls(str(tmp_path), labels=[1, 2, 3])


@pytest.fixture
def jax_native_io(monkeypatch):
    """The JAX module remembers PATCHGAN_NATIVE_IO=off for good; give it
    fresh state for the test and put its own back after."""
    monkeypatch.setattr(jax_native, '_lib', None)
    monkeypatch.setattr(jax_native, '_build_failed', False)


def test_native_builds_under_the_port():
    assert native.native_status() == 'built'
    assert native._library_path().startswith(
        os.path.join(ROOT, 'patchgan_tpu_torch', '_build'))
    assert os.path.exists(native._library_path())


@pytest.mark.parametrize('size', [None, 32, 24])
@pytest.mark.parametrize('fn', ['decode_jpeg_rgb', 'decode_jpeg_rgb_u8',
                                'decode_png_gray', 'decode_png_gray_u8'])
@pytest.mark.parametrize('io_mode', ['on', 'off'])
def test_decode_matches_jax(image_files, monkeypatch, jax_native_io, fn,
                            size, io_mode):
    """Each entry point, resized and not, bit for bit against the JAX
    module: the native libraries (built from two copies of one source),
    or with PATCHGAN_NATIVE_IO=off the two PIL paths."""
    monkeypatch.setenv('PATCHGAN_NATIVE_IO', io_mode)
    path = image_files[0] if 'jpeg' in fn else image_files[1]
    got = getattr(native, fn)(path, size)
    want = getattr(jax_native, fn)(path, size)
    assert native.native_available() == (io_mode == 'on')
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.shape[:2] == ((size, size) if size else (45, 70))
    np.testing.assert_array_equal(got, want)


def test_native_and_pil_decode_within_two_levels(image_files,
                                                  monkeypatch):
    """Unresized, libjpeg and PIL decode within 2 grey levels; the native
    path's own resize is not PIL's antialiased one, so both are needed."""
    native_full = native.decode_jpeg_rgb_u8(image_files[0])
    monkeypatch.setenv('PATCHGAN_NATIVE_IO', 'off')
    pil_full = native.decode_jpeg_rgb_u8(image_files[0])
    diff = np.abs(native_full.astype(int) - pil_full.astype(int))
    assert diff.max() <= 2
    assert native.native_status() == 'unavailable: PATCHGAN_NATIVE_IO=off'


def test_failed_build_falls_back_to_pil(image_files, monkeypatch):
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_error', 'RuntimeError: no g++')
    assert native.native_status() == 'unavailable: RuntimeError: no g++'
    got = native.decode_png_gray(image_files[1], 16)
    np.testing.assert_array_equal(got, native._pil_png(image_files[1], 16))


def test_file_the_library_rejects_goes_to_pil(tmp_path, image_files):
    """A PNG named .jpg: libjpeg refuses its header, PIL reads it."""
    fake = tmp_path / 'png_named.jpg'
    shutil.copy(image_files[1], fake)
    got = native.decode_jpeg_rgb_u8(str(fake), None)
    np.testing.assert_array_equal(got, native._pil_jpeg_u8(str(fake), None))
    assert got.shape == (45, 70, 3)


@pytest.mark.parametrize('which', [0, 1], ids=['jpeg', 'png'])
def test_serve_decode_matches_jax(image_files, which):
    """JPEGs through the native u8 decode, PNGs through PIL, in both
    servers."""
    np.testing.assert_array_equal(serve_decode(image_files[which]),
                                  jax_serve_decode(image_files[which]))


@pytest.mark.parametrize('ff,skip', [(0, 1), (1, 0), (2, 2), (1, 3)])
def test_fast_forward_and_skip_match_jax(npz_ds, ff, skip):
    """After fast_forward(ff) + skip_next(skip), the port loader gives the
    JAX loader's batches (its order, its values), that epoch and the
    next."""
    ours = DataLoader(npz_ds, batch_size=3, num_workers=2, seed=7)
    theirs = JaxLoader(npz_ds, batch_size=3, num_workers=2, seed=7)
    for loader in (ours, theirs):
        loader.fast_forward(ff)
        loader.skip_next(skip)
    for epoch in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 3 - (skip if epoch == 0 else 0)
        for (x, y), (jx, jy) in zip(got, want):
            np.testing.assert_array_equal(
                np.transpose(x.numpy(), (0, 2, 3, 1)), np.asarray(jx))
            np.testing.assert_array_equal(
                np.transpose(y.numpy(), (0, 2, 3, 1)), np.asarray(jy))
    assert ours.epoch == theirs._epoch == ff + 2


@pytest.mark.parametrize('ff,skip', [(0, 1), (1, 2), (2, 3)])
def test_skipped_epoch_keeps_later_flips(npz_ds, ff, skip):
    """With flips on, a loader fast-forwarded to an epoch and skipping its
    first batches gives exactly the rest of that epoch of an
    uninterrupted loader, flips included."""
    npz_ds.augmentation = 'randomcrop+flip'
    full = DataLoader(npz_ds, batch_size=2, drop_last=False, seed=4)
    for _ in range(ff):
        list(full)
    want = list(full)
    part = DataLoader(npz_ds, batch_size=2, drop_last=False, seed=4)
    part.fast_forward(ff)
    part.skip_next(skip)
    got = list(part)
    assert len(got) == len(want) - skip == 6 - skip
    for (x, y), (wx, wy) in zip(got, want[skip:]):
        assert torch.equal(x, wx) and torch.equal(y, wy)
    # the flips are on: the same order unflipped differs somewhere
    npz_ds.augmentation = None
    unflipped = DataLoader(npz_ds, batch_size=2, drop_last=False, seed=4)
    unflipped.fast_forward(ff)
    assert any(not torch.equal(x, ux)
               for (x, _), (ux, _) in zip(want, unflipped))


def test_flip_seed_depends_on_each_part():
    seeds = {flip_seed(s, e, b) for s in (0, 1) for e in (1, 2)
             for b in (0, 1, 2)}
    assert len(seeds) == 12
    assert flip_seed(3, 2, 1) == flip_seed(3, 2, 1)


class _Counting(COCOStuffDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.decodes = 0

    def load_raw_u8(self, index):
        self.decodes += 1
        return super().load_raw_u8(index)


def test_cache_skips_the_decoder_after_epoch_one(coco_dir):
    ds = _Counting(*coco_dir, labels=[1, 2, 3], size=32,
                   augmentation='randomcrop+flip')
    cached = DataLoader(ds, batch_size=4, drop_last=False, num_workers=3,
                        seed=2, cache=True)
    plain = DataLoader(COCOStuffDataset(*coco_dir, labels=[1, 2, 3],
                                        size=32,
                                        augmentation='randomcrop+flip'),
                       batch_size=4, drop_last=False, seed=2)
    for epoch in range(3):
        got, want = list(cached), list(plain)
        assert ds.decodes == 10, epoch
        for (x, y), (wx, wy) in zip(got, want):
            assert torch.equal(x, wx) and torch.equal(y, wy)
    assert len(cached._cache) == 10
    assert cached._cache_bytes == 10 * (32 * 32 * 3 + 32 * 32)


def test_cache_byte_budget_holds(coco_dir):
    ds = _Counting(*coco_dir, labels=[1, 2, 3], size=32,
                   augmentation='randomcrop')
    pair = 32 * 32 * 3 + 32 * 32
    loader = DataLoader(ds, batch_size=5, num_workers=4, seed=1,
                        cache=3 * pair + 10)
    list(loader)
    assert len(loader._cache) == 3
    assert loader._cache_bytes == 3 * pair
    list(loader)
    assert ds.decodes == 10 + 7
    assert len(loader._cache) == 3


def test_process_workers_match_threads_and_close(coco_dir):
    """Process workers give the threads' batches, over two epochs of one
    persistent pool, and close() releases it."""
    ds = COCOStuffDataset(*coco_dir, labels=[1, 2, 3], size=32,
                          augmentation='randomcrop+flip')
    threads = DataLoader(ds, batch_size=4, drop_last=False, seed=8,
                         num_workers=2)
    procs = DataLoader(ds, batch_size=4, drop_last=False, seed=8,
                       num_workers=2, worker_type='process')
    try:
        for _ in range(2):
            got, want = list(procs), list(threads)
            assert len(got) == len(want) == 3
            for (x, y), (wx, wy) in zip(got, want):
                assert torch.equal(x, wx) and torch.equal(y, wy)
        pool = procs._proc_pool
        workers = list(pool._processes.values())
        assert len(workers) == 2 and all(p.is_alive() for p in workers)
    finally:
        procs.close()
    assert procs._proc_pool is None
    for p in workers:
        p.join(timeout=10)
        assert not p.is_alive()


class _ItemDataset:
    """No load_raw: the loader stacks ``__getitem__``'s pairs."""

    def __len__(self):
        return 5

    def __getitem__(self, i):
        return (np.full((4, 4, 3), i, np.float32),
                np.full((4, 4, 1), i % 2, np.float32))


def test_process_workers_getitem_datasets(npz_ds):
    """A dataset without load_raw goes through __getitem__ in the
    workers; a plugin dataset from a cwd io.py cannot reach them, and
    says so before any worker starts."""
    with pytest.raises(ValueError, match="does not pickle.*io.py"):
        next(iter(DataLoader(npz_ds, num_workers=2,
                             worker_type='process')))
    loader = DataLoader(_ItemDataset(), batch_size=5, shuffle=False,
                        num_workers=2, worker_type='process')
    try:
        x, y = next(iter(loader))
    finally:
        loader.close()
    assert x.shape == (5, 3, 4, 4) and y.shape == (5, 1, 4, 4)
    assert torch.equal(x[:, 0, 0, 0], torch.arange(5.0))


@pytest.mark.parametrize('kwargs,match', [
    ({'worker_type': 'process', 'num_workers': 0}, 'num_workers=0'),
    ({'worker_type': 'process', 'cache': True}, 'RAM cache'),
    ({'worker_type': 'fiber'}, 'worker_type')],
    ids=['process-sync', 'process-cache', 'unknown'])
def test_loader_option_errors(npz_ds, kwargs, match):
    with pytest.raises(ValueError, match=match):
        DataLoader(npz_ds, **kwargs)
