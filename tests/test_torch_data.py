"""The port's data pipeline against the JAX package's: the same folder
and seed give the same batches (npz plugin, flips off), the COCO reader
decodes as the JAX one does, splits agree, and device flips move image
and mask together. Per-host slicing, not ported, raises."""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from patchgan_tpu.data import COCOStuffDataset as JaxCOCO
from patchgan_tpu.data import DataLoader as JaxLoader
from patchgan_tpu.data.split import random_split as jax_split
from patchgan_tpu_torch.data import COCOStuffDataset, DataLoader
from patchgan_tpu_torch.data.plugin import load_dataset_class
from patchgan_tpu_torch.data.split import random_split

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def npz_ds(tmp_path, monkeypatch):
    shutil.copy(os.path.join(ROOT, 'examples', 'io_plugin_example.py'),
                tmp_path / 'io.py')
    rng = np.random.default_rng(40)
    for i in range(7):
        np.savez(tmp_path / f'{i:03d}.npz',
                 image=rng.random((16, 24, 3), dtype=np.float32),
                 labels=rng.integers(1, 4, (16, 24)).astype(np.int32))
    monkeypatch.chdir(tmp_path)
    cls = load_dataset_class('NpzSegmentationDataset')
    return cls(str(tmp_path), labels=[1, 2, 3])


@pytest.fixture
def coco_dir(tmp_path):
    imgdir, maskdir = tmp_path / 'images', tmp_path / 'masks'
    imgdir.mkdir()
    maskdir.mkdir()
    rng = np.random.default_rng(41)
    for i in range(5):
        img = (rng.uniform(size=(40, 56, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(imgdir / f'{i:012d}.jpg')
        mask = rng.integers(0, 3, size=(40, 56)).astype(np.uint8)
        Image.fromarray(mask, mode='L').save(maskdir / f'{i:012d}.png')
    return str(imgdir), str(maskdir)


@pytest.mark.parametrize('drop_last', [True, False])
def test_loader_batches_match_jax(npz_ds, drop_last):
    """Two epochs of (x, y) from both loaders, seed 3, batch 3: the same
    shuffle order and values (NCHW here, NHWC there)."""
    ours = DataLoader(npz_ds, batch_size=3, drop_last=drop_last,
                      num_workers=2, seed=3)
    theirs = JaxLoader(npz_ds, batch_size=3, drop_last=drop_last,
                       num_workers=2, seed=3)
    assert len(ours) == len(theirs) == (2 if drop_last else 3)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for (x, y), (jx, jy) in zip(got, want):
            assert x.dtype == y.dtype == torch.float32
            np.testing.assert_array_equal(
                np.transpose(x.numpy(), (0, 2, 3, 1)), np.asarray(jx))
            np.testing.assert_array_equal(
                np.transpose(y.numpy(), (0, 2, 3, 1)), np.asarray(jy))


def test_loader_bf16_and_sync_decode(npz_ds):
    """num_workers=0 decodes in the producer thread; dtype casts x and
    the one-hot y."""
    x, y = next(iter(DataLoader(npz_ds, batch_size=4, num_workers=0,
                                dtype=torch.bfloat16)))
    assert x.shape == (4, 3, 16, 24) and y.shape == (4, 3, 16, 24)
    assert x.dtype == y.dtype == torch.bfloat16
    assert torch.equal(y.float().sum(1), torch.ones(4, 16, 24))


def test_coco_reader_matches_jax(coco_dir):
    """The port's reader against the JAX one, both decoding through the
    native library: the same images, masks + 1 and one-hot, exactly, at
    the original size ('resize' is no transform)."""
    ours = COCOStuffDataset(*coco_dir, labels=[3, 1, 2],
                            augmentation='resize')
    theirs = JaxCOCO(*coco_dir, labels=[3, 1, 2], augmentation='resize')
    assert len(ours) == len(theirs) == 5
    for i in range(5):
        (img, lab), (jimg, jlab) = ours.load_raw(i), theirs.load_raw(i)
        assert img.shape == (40, 56, 3) and img.dtype == np.float32
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(lab, jlab)
        (_, oh), (_, joh) = ours[i], theirs[i]
        np.testing.assert_array_equal(oh, joh)
        u8, raw = ours.load_raw_u8(i)
        assert u8.dtype == np.uint8 and np.array_equal(raw + 1, lab)


def test_coco_resize_and_loader_one_hot(coco_dir):
    """'randomcrop' resizes to (size, size), the mask NEAREST (every
    pixel keeps one label); the loader's uint8 path one-hots the raw
    mask against the labels less one."""
    ds = COCOStuffDataset(*coco_dir, labels=[1, 2, 3], size=32,
                          augmentation='randomcrop')
    img, lab = ds.load_raw(0)
    assert img.shape == (32, 32, 3) and set(np.unique(lab)) <= {1, 2, 3}
    x, y = next(iter(DataLoader(ds, batch_size=2, num_workers=1)))
    assert x.shape == (2, 3, 32, 32) and float(x.max()) <= 1.0
    assert torch.equal(y.sum(1), torch.ones(2, 32, 32))


def test_coco_id_mismatch_raises(tmp_path):
    (tmp_path / 'i').mkdir()
    (tmp_path / 'm').mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        tmp_path / 'i' / '1.jpg')
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(
        tmp_path / 'm' / '2.png')
    with pytest.raises(ValueError, match='IDs'):
        COCOStuffDataset(str(tmp_path / 'i'), str(tmp_path / 'm'))


def test_device_flips_move_image_and_mask_together(npz_ds):
    """'randomcrop+flip': each sample is either unflipped or flipped the
    same way in x and y, and some are flipped (p = 0.25 per axis)."""
    x0, y0 = next(iter(DataLoader(npz_ds, batch_size=7, shuffle=False)))
    npz_ds.augmentation = 'randomcrop+flip'
    flipped = DataLoader(npz_ds, batch_size=7, shuffle=False, seed=5)
    seen = 0
    for _ in range(4):
        x, y = next(iter(flipped))
        for i in range(7):
            for dims in ((), (3,), (2,), (2, 3)):
                fx = x0[i].flip(tuple(d - 1 for d in dims)) if dims \
                    else x0[i]
                if torch.equal(x[i], fx):
                    fy = y0[i].flip(tuple(d - 1 for d in dims)) if dims \
                        else y0[i]
                    assert torch.equal(y[i], fy)
                    seen += bool(dims)
                    break
            else:
                raise AssertionError(f'sample {i} is no flip of itself')
    assert seen > 0


def test_random_split_matches_jax(npz_ds):
    for lengths in ([0.7, 0.3], [5, 2]):
        ours = random_split(npz_ds, lengths, seed=4)
        theirs = jax_split(npz_ds, lengths, seed=4)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.indices, b.indices)
            np.testing.assert_array_equal(a.load_raw(0)[1],
                                          b.load_raw(0)[1])


@pytest.mark.parametrize('kwargs,match', [
    ({'process_index': 0, 'process_count': 3}, 'batch 16 must divide'),
    ({'process_count': 2}, 'process_index is required')],
    ids=['per-host', 'one-host'])
def test_unported_loader_options_raise(npz_ds, kwargs, match):
    """Per-rank slicing is ported (tests/test_torch_parallel.py); what it
    cannot slice raises, as in the JAX loader: a global batch that does
    not divide across the ranks, and a count given without this
    process's index (which would decode rank 0's rows everywhere)."""
    with pytest.raises(ValueError, match=match):
        DataLoader(npz_ds, **kwargs)
