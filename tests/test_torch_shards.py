"""The port's TarShardDataset, case by case as the JAX package's tests hold
its own (``tests/test_data.py``), and against the JAX dataset on the
same shards: the same pairs in the same order, decoded to the same
pixels."""

import os
import pickle
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from patchgan_tpu.data import TarShardDataset as JaxShards
from patchgan_tpu_torch.cli.common import build_dataset_factory
from patchgan_tpu_torch.data import COCOStuffDataset, DataLoader
from patchgan_tpu_torch.data import TarShardDataset
from patchgan_tpu_torch.data.shards import _MAX_OPEN_TARS


@pytest.fixture
def coco_dir(tmp_path):
    imgdir = tmp_path / 'images'
    maskdir = tmp_path / 'masks'
    imgdir.mkdir()
    maskdir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        img = (rng.uniform(size=(64, 48, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(imgdir / f'{i:012d}.jpg')
        mask = rng.integers(0, 3, size=(64, 48)).astype(np.uint8)
        Image.fromarray(mask, mode='L').save(maskdir / f'{i:012d}.png')
    return str(imgdir), str(maskdir)


@pytest.fixture
def tar_shards(coco_dir, tmp_path):
    """The coco_dir pairs as two tar shards of 4 pairs each, from the same
    encoded files."""
    imgdir, maskdir = coco_dir
    shard_dir = tmp_path / 'shards'
    shard_dir.mkdir()
    for si in range(2):
        with tarfile.open(shard_dir / f'shard-{si}.tar', 'w') as tf:
            for i in range(4 * si, 4 * si + 4):
                tf.add(os.path.join(imgdir, f'{i:012d}.jpg'),
                       arcname=f'{i:012d}.jpg')
                tf.add(os.path.join(maskdir, f'{i:012d}.png'),
                       arcname=f'{i:012d}.png')
    return str(shard_dir / 'shard-*.tar')


@pytest.mark.parametrize('augmentation', ['resize', 'randomcrop'])
def test_tar_shards_match_jax(tar_shards, augmentation):
    """The port's dataset against the JAX one on the same shards: the same
    order, file names and decodes (u8 and float), original size or
    resized."""
    ours = TarShardDataset(tar_shards, labels=[1, 2, 3], size=32,
                           augmentation=augmentation)
    theirs = JaxShards(tar_shards, labels=[1, 2, 3], size=32,
                       augmentation=augmentation)
    assert len(ours) == len(theirs) == 8
    assert ours._index == theirs._index
    for i in range(8):
        assert ours.get_filename(i) == theirs.get_filename(i)
        for method in ('load_raw_u8', 'load_raw'):
            for a, b in zip(getattr(ours, method)(i),
                            getattr(theirs, method)(i)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours.get_image(i), theirs.get_image(i))


def test_tar_shards_match_folder_dataset(coco_dir, tar_shards):
    """A drop-in for COCOStuffDataset: same order, same decodes (PIL here,
    libjpeg there: within 1 grey level unresized), same one-hot."""
    folder = COCOStuffDataset(*coco_dir, labels=[1, 2, 3], size=32)
    tars = TarShardDataset(tar_shards, labels=[1, 2, 3], size=32)
    assert len(tars) == len(folder) == 8
    for i in (0, 3, 4, 7):  # both shards
        fi, fm = folder.load_raw_u8(i)
        ti, tm = tars.load_raw_u8(i)
        assert np.max(np.abs(fi.astype(int) - ti.astype(int))) <= 1
        np.testing.assert_array_equal(fm, tm)

    tars_r = TarShardDataset(tar_shards, labels=[1, 2, 3], size=32,
                             augmentation='randomcrop')
    for i in (0, 7):
        img, onehot = tars_r[i]
        assert img.shape == (32, 32, 3) and onehot.shape == (32, 32, 3)
        np.testing.assert_array_equal(onehot.sum(axis=-1), 1.0)


def test_tar_shards_equal_the_folder_with_pil(coco_dir, tar_shards,
                                              monkeypatch):
    """With PATCHGAN_NATIVE_IO=off both datasets decode with PIL: the
    loader's batches from the shards and from the folder are equal,
    flips on."""
    monkeypatch.setenv('PATCHGAN_NATIVE_IO', 'off')
    kw = dict(labels=[1, 2, 3], size=32, augmentation='randomcrop+flip')
    folder = DataLoader(COCOStuffDataset(*coco_dir, **kw), batch_size=3,
                        drop_last=False, seed=5)
    tars = DataLoader(TarShardDataset(tar_shards, **kw), batch_size=3,
                      drop_last=False, seed=5)
    for _ in range(2):
        for (x, y), (fx, fy) in zip(tars, folder):
            assert torch.equal(x, fx) and torch.equal(y, fy)


def test_tar_shards_dataloader_end_to_end(tar_shards):
    ds = TarShardDataset(tar_shards, labels=[1, 2, 3], size=32,
                         augmentation='randomcrop')
    loader = DataLoader(ds, batch_size=4, shuffle=False, num_workers=2)
    batches = list(loader)
    assert len(batches) == 2
    x, y = batches[0]
    assert x.shape == (4, 3, 32, 32) and y.shape == (4, 3, 32, 32)
    assert float(x.min()) >= 0.0
    assert torch.equal(y.sum(1), torch.ones(4, 32, 32))


def test_tar_shards_pickle_and_infer_protocol(tar_shards):
    """Open tar handles are per thread and dropped on pickle (the process
    workers' path); the inference protocol works."""
    ds = TarShardDataset(tar_shards, labels=[1], size=32)
    ds.load_raw_u8(0)  # open a handle, then pickle anyway
    ds2 = pickle.loads(pickle.dumps(ds))
    for a, b in zip(ds.load_raw_u8(5), ds2.load_raw_u8(5)):
        np.testing.assert_array_equal(a, b)
    assert ds.get_filename(0).endswith('.jpg')
    img = ds.get_image(0)
    assert img.shape == (64, 48, 3)  # original resolution
    assert 0.0 <= img.min() and img.max() <= 1.0


def test_tar_shards_in_process_workers(tar_shards):
    ds = TarShardDataset(tar_shards, labels=[1, 2, 3], size=32,
                         augmentation='randomcrop+flip')
    procs = DataLoader(ds, batch_size=4, seed=3, num_workers=2,
                       worker_type='process')
    threads = DataLoader(ds, batch_size=4, seed=3, num_workers=2)
    try:
        for (x, y), (tx, ty) in zip(procs, threads):
            assert torch.equal(x, tx) and torch.equal(y, ty)
    finally:
        procs.close()


def test_tar_shards_subdir_stems_and_duplicates(coco_dir, tmp_path):
    """Pair keys are the full member path minus extension: members in
    different subdirectories of one tar are distinct pairs, and a true
    duplicate stem raises."""
    imgdir, maskdir = coco_dir
    tar_path = tmp_path / 'subdirs.tar'
    with tarfile.open(tar_path, 'w') as tf:
        for sub, i in (('a', 0), ('b', 1)):
            tf.add(os.path.join(imgdir, f'{i:012d}.jpg'),
                   arcname=f'{sub}/0001.jpg')
            tf.add(os.path.join(maskdir, f'{i:012d}.png'),
                   arcname=f'{sub}/0001.png')
    ds = TarShardDataset(str(tar_path), labels=[1, 2, 3], size=32)
    assert len(ds) == 2
    (ia, ma), (ib, mb) = ds.load_raw_u8(0), ds.load_raw_u8(1)
    assert not np.array_equal(ia, ib)  # two distinct source images
    # each image kept its own mask (a/0001.png with a/0001.jpg)
    ref = COCOStuffDataset(*coco_dir, labels=[1, 2, 3], size=32)
    np.testing.assert_array_equal(ma, ref.load_raw_u8(0)[1])
    np.testing.assert_array_equal(mb, ref.load_raw_u8(1)[1])

    dup = tmp_path / 'dup.tar'
    with tarfile.open(dup, 'w') as tf:
        tf.add(os.path.join(imgdir, '000000000000.jpg'), arcname='x.jpg')
        tf.add(os.path.join(imgdir, '000000000001.jpg'), arcname='x.jpg')
    with pytest.raises(ValueError, match='duplicate member stem'):
        TarShardDataset(str(dup), labels=[1], size=32)


def test_tar_shards_split_layout_basename_fallback(coco_dir, tmp_path):
    """A split images/ + masks/ layout pairs by unique basename; ambiguous
    basenames raise instead of mispairing."""
    imgdir, maskdir = coco_dir
    tar_path = tmp_path / 'split.tar'
    with tarfile.open(tar_path, 'w') as tf:
        for i in range(2):
            tf.add(os.path.join(imgdir, f'{i:012d}.jpg'),
                   arcname=f'images/{i:04d}.jpg')
            tf.add(os.path.join(maskdir, f'{i:012d}.png'),
                   arcname=f'masks/{i:04d}.png')
    ds = TarShardDataset(str(tar_path), labels=[1, 2, 3], size=32)
    assert len(ds) == 2
    ref = COCOStuffDataset(*coco_dir, labels=[1, 2, 3], size=32)
    for i in range(2):
        np.testing.assert_array_equal(ds.load_raw_u8(i)[1],
                                      ref.load_raw_u8(i)[1])

    amb = tmp_path / 'ambiguous.tar'
    with tarfile.open(amb, 'w') as tf:
        tf.add(os.path.join(imgdir, '000000000000.jpg'),
               arcname='images/0001.jpg')
        tf.add(os.path.join(maskdir, '000000000000.png'),
               arcname='masks_a/0001.png')
        tf.add(os.path.join(maskdir, '000000000001.png'),
               arcname='masks_b/0001.png')
    with pytest.raises(ValueError, match='ambiguous mask basename'):
        TarShardDataset(str(amb), labels=[1], size=32)


def test_tar_shards_handle_cache_bounded(coco_dir, tmp_path):
    """The per-thread open-tar LRU stays within its budget while every
    shard stays readable."""
    imgdir, maskdir = coco_dir
    n_shards = _MAX_OPEN_TARS + 4
    shard_dir = tmp_path / 'many'
    shard_dir.mkdir()
    for si in range(n_shards):
        i = si % 8
        with tarfile.open(shard_dir / f's-{si:02d}.tar', 'w') as tf:
            tf.add(os.path.join(imgdir, f'{i:012d}.jpg'),
                   arcname=f'{si:02d}.jpg')
            tf.add(os.path.join(maskdir, f'{i:012d}.png'),
                   arcname=f'{si:02d}.png')
    ds = TarShardDataset(str(shard_dir / 's-*.tar'), labels=[1], size=32)
    assert len(ds) == n_shards
    for idx in range(n_shards):
        ds.load_raw_u8(idx)
        assert len(ds._local.handles) <= _MAX_OPEN_TARS
    # wrap around: evicted shards reopen transparently
    ds.load_raw_u8(0)
    assert len(ds._local.handles) <= _MAX_OPEN_TARS


def test_tar_shards_missing_mask_raises(coco_dir, tmp_path):
    """Inference-only shards hold no masks: the images decode, the
    training path names the member."""
    tar_path = tmp_path / 'images_only.tar'
    with tarfile.open(tar_path, 'w') as tf:
        tf.add(os.path.join(coco_dir[0], '000000000002.jpg'),
               arcname='0002.jpg')
    ds = TarShardDataset(str(tar_path), labels=[1], size=32)
    assert ds.get_image(0).shape == (64, 48, 3)
    with pytest.raises(KeyError, match='0002.jpg'):
        ds.load_raw_u8(0)


def test_tar_shards_factory_and_missing(tmp_path):
    cls, in_ch, out_ch, kwargs = build_dataset_factory(
        {'type': 'TarShards', 'labels': [1, 2]})
    assert cls is TarShardDataset and (in_ch, out_ch) == (3, 2)
    assert kwargs == {'labels': [1, 2]}
    with pytest.raises(FileNotFoundError):
        TarShardDataset(str(tmp_path / 'nope-*.tar'))
