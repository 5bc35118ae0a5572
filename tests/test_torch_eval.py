"""The port's metrics and ``patchgan_eval`` against the JAX package.

Metrics: ``iou``, ``dice``, ``boundary_f1`` (tolerance 0 and 2),
``confusion_matrix`` and ``iou_from_confusion`` on the same masks (NHWC
for JAX, NCHW for the port), within 1e-6, for one class (thresholded)
and four (arg-maxed; one absent from truth and prediction), with regions
inside the image and regions on its border.

CLI: ``patchgan_eval -d cpu --dtype float32`` and the JAX CLI on one npz
checkpoint and one labelled npz-plugin folder give the same
``n_images``, and ``value``, ``mean_dice`` and ``mean_boundary_f1``
within 2e-3; ``-d auto`` / ``-d cuda`` without a GPU, an empty folder, a
folder without masks, a partial checkpoint and an unset
``checkpoint_path`` raise; the newest epoch checkpoint is chosen by its
number.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from patchgan_tpu.cli.evaluate import patchgan_eval as jax_eval
from patchgan_tpu.utils import metrics as jax_metrics
from patchgan_tpu_torch.cli.evaluate import patchgan_eval
from patchgan_tpu_torch.models import UNet
from patchgan_tpu_torch.utils import metrics
from patchgan_tpu_torch.utils.checkpoint import save_state_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _regions(rng, n, h, w, classes, border):
    """(N, H, W) label maps of rectangles: classes 1.. on class 0, each
    rectangle touching the image border when ``border``."""
    maps = np.zeros((n, h, w), np.int64)
    for i in range(n):
        for c in range(1, classes):
            for _ in range(2):
                y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
                y1 = y0 + rng.integers(3, h // 2)
                x1 = x0 + rng.integers(3, w // 2)
                if border:
                    y0, x1 = 0, w
                maps[i, y0:y1, x0:x1] = c
    return maps


def _masks(classes, border, present):
    """(truth one-hot, predicted probabilities), NHWC float32: the
    prediction is the truth shifted by (2, 3) pixels with 1% of its
    pixels relabelled; ``present`` classes are drawn of ``classes``
    channels."""
    rng = np.random.default_rng(classes * 10 + border)
    n, h, w = 3, 40, 48
    truth = _regions(rng, n, h, w, present, border)
    pred = np.roll(truth, (2, 3), axis=(1, 2))
    flip = rng.uniform(size=pred.shape) < 0.01
    pred[flip] = rng.integers(0, present, pred.shape)[flip]
    noise = rng.uniform(size=(n, h, w, classes)).astype(np.float32)
    if classes == 1:
        return ((truth > 0)[..., None].astype(np.float32),
                0.7 * (pred > 0)[..., None] + 0.3 * noise)
    eye = np.eye(classes, dtype=np.float32)
    return eye[truth], 0.7 * eye[pred] + 0.3 * noise


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a,
                                                              (0, 3, 1, 2))))


CASES = {'1class': (1, 2), '4class-1absent': (4, 3)}


@pytest.mark.parametrize('border', [False, True], ids=['inside', 'border'])
@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('name,kwargs', [
    ('iou', {}), ('dice', {}), ('boundary_f1', {'tolerance': 0}),
    ('boundary_f1', {'tolerance': 2})],
    ids=['iou', 'dice', 'bf1-tol0', 'bf1-tol2'])
def test_metric_matches_jax(name, kwargs, case, border):
    classes, present = CASES[case]
    y_true, y_pred = _masks(classes, border, present)
    want = float(getattr(jax_metrics, name)(jnp.asarray(y_true),
                                            jnp.asarray(y_pred), **kwargs))
    got = getattr(metrics, name)(_nchw(y_true), _nchw(y_pred), **kwargs)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert 0.0 < want < 1.0
    assert abs(float(got) - want) <= 1e-6


@pytest.mark.parametrize('case', sorted(CASES))
def test_confusion_matrix_matches_jax(case):
    classes, present = CASES[case]
    y_true, y_pred = _masks(classes, True, present)
    labels = np.argmax(y_true, -1) if classes > 1 else y_true[..., 0]
    pred = np.argmax(y_pred, -1) if classes > 1 else y_pred[..., 0] >= 0.5
    n = max(classes, 2)
    want = np.asarray(jax_metrics.confusion_matrix(
        jnp.asarray(labels), jnp.asarray(pred), n))
    got = metrics.confusion_matrix(torch.from_numpy(labels.astype(np.int64)),
                                   torch.from_numpy(pred.astype(np.int64)),
                                   n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        metrics.iou_from_confusion(got).numpy(),
        np.asarray(jax_metrics.iou_from_confusion(jnp.asarray(want))),
        rtol=0, atol=1e-6)


PLUGIN_3CLASS = '''

class NpzThreeClassDataset(NpzSegmentationDataset):
    def __init__(self, folder, maskfolder=None, size=256,
                 augmentation='resize', labels=(1, 2, 3), **kwargs):
        super().__init__(folder, maskfolder, size, augmentation, labels)
'''


@pytest.fixture
def eval_dir(tmp_path, monkeypatch):
    """The npz plugin (and a three-class subclass, since the JAX CLI
    passes no labels to a plugin) and a folder of five labelled 128-px
    images, labels 1-3 in rectangles on 0."""
    shutil.copy(os.path.join(ROOT, 'examples', 'io_plugin_example.py'),
                tmp_path / 'io.py')
    with open(tmp_path / 'io.py', 'a') as f:
        f.write(PLUGIN_3CLASS)
    rng = np.random.default_rng(70)
    (tmp_path / 'val').mkdir()
    labels = _regions(rng, 5, 128, 128, 4, False)
    for i in range(5):
        np.savez(tmp_path / 'val' / f'{i:03d}.npz',
                 image=rng.random((128, 128, 3), dtype=np.float32),
                 labels=labels[i].astype(np.int32))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _eval_config(root, classes, ckpt=None, data='val', **extra):
    cfg = {
        'dataset': {'type': ('NpzSegmentationDataset' if classes == 1 else
                             'NpzThreeClassDataset'),
                    'size': 128, 'in_channels': 3, 'out_channels': classes,
                    'validation_data': {'images': data, 'masks': data}},
        'model_params': {'generator': {
            'filters': 8, 'activation': 'relu',
            'final_activation': 'sigmoid' if classes == 1 else 'softmax'}},
    }
    if ckpt is not None:
        cfg['checkpoint_paths'] = {'generator': ckpt}
    cfg.update(extra)
    path = root / 'eval.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _save_generator(path, classes, seed=1, encoder_only=False):
    gen = UNet(3, classes, nf=8, activation='relu',
               final_act='sigmoid' if classes == 1 else 'softmax',
               generator=torch.Generator().manual_seed(seed))
    sd = gen.state_dict()
    if encoder_only:
        sd = {k: v for k, v in sd.items() if 'encoder' in k}
    save_state_dict(str(path), sd)
    return str(path)


CLI_ARGS = ['-d', 'cpu', '--dtype', 'float32', '-b', '2',
            '--dataloader_workers', '1', '--metrics', 'iou,dice,bf1,foo']


@pytest.mark.parametrize('classes', [1, 3])
def test_eval_cli_matches_jax(eval_dir, classes, capsys):
    """Five images in batches of 2, 2 and 1: the batch-size-weighted
    means of both CLIs; the unknown metric is reported and dropped."""
    cfg = _eval_config(eval_dir, classes, _save_generator(
        eval_dir / 'gen.npz', classes))
    got = patchgan_eval(['-c', cfg] + CLI_ARGS)
    out = capsys.readouterr().out
    assert 'Ignoring unknown metrics: foo' in out
    assert json.loads(out.strip().splitlines()[-1]) == got
    want = jax_eval(['-c', cfg] + CLI_ARGS)
    assert list(got) == list(want) == [
        'metric', 'value', 'n_images', 'checkpoint', 'mean_dice',
        'mean_boundary_f1']
    assert got['metric'] == 'mean_iou' and got['n_images'] == 5 == \
        want['n_images'] and got['checkpoint'] == want['checkpoint']
    for key in ('value', 'mean_dice', 'mean_boundary_f1'):
        assert 0.0 <= got[key] <= 1.0
        assert abs(got[key] - want[key]) <= 2e-3, key


def test_eval_cli_picks_the_newest_epoch(eval_dir, capsys):
    """Without checkpoint_paths the largest epoch number under
    checkpoint_path is evaluated (1000, not 999 as strings would give)."""
    (eval_dir / 'ck').mkdir()
    for epoch in ('002', '010', '999', '1000'):
        _save_generator(eval_dir / 'ck' / f'generator_ep_{epoch}.npz', 1)
    got = patchgan_eval(['-c', _eval_config(eval_dir, 1,
                                            checkpoint_path='ck')]
                        + CLI_ARGS[:-2])
    assert got['checkpoint'].endswith('generator_ep_1000.npz')
    assert list(got) == ['metric', 'value', 'n_images', 'checkpoint']
    assert 'Evaluating newest checkpoint' in capsys.readouterr().out


def test_eval_cli_newest_epoch_is_an_npz(eval_dir):
    """Only generator_ep_*.npz files count: a torch .pth beside the npz of
    the same epoch, or of a later one, changes nothing."""
    (eval_dir / 'ck').mkdir()
    for epoch in ('002', '003'):
        _save_generator(eval_dir / 'ck' / f'generator_ep_{epoch}.npz', 1)
    for epoch in ('003', '004'):
        torch.save(UNet(3, 1, nf=8).state_dict(),
                   eval_dir / 'ck' / f'generator_ep_{epoch}.pth')
    got = patchgan_eval(['-c', _eval_config(eval_dir, 1,
                                            checkpoint_path='ck')]
                        + CLI_ARGS[:-2])
    assert got['checkpoint'].endswith('generator_ep_003.npz')


@pytest.mark.parametrize('device', ['cuda', 'auto'])
def test_eval_cli_without_gpu_raises(eval_dir, device, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = _eval_config(eval_dir, 1, _save_generator(eval_dir / 'g.npz', 1))
    with pytest.raises(RuntimeError, match='-d cpu'):
        patchgan_eval(['-c', cfg, '-d', device])


def test_eval_cli_refuses_bad_inputs(eval_dir):
    """An empty folder, a folder whose images have no masks, a partial
    checkpoint, and no checkpoint path at all each raise ValueError."""
    ckpt = _save_generator(eval_dir / 'g.npz', 1)
    (eval_dir / 'empty').mkdir()
    with pytest.raises(ValueError, match='empty'):
        patchgan_eval(['-c', _eval_config(eval_dir, 1, ckpt, data='empty')]
                      + CLI_ARGS)
    (eval_dir / 'jpgs').mkdir()
    (eval_dir / 'jpgs' / '0.jpg').write_bytes(b'')
    cfg = _eval_config(eval_dir, 1, ckpt)
    with open(cfg) as f:
        config = yaml.safe_load(f)
    config['dataset'] = {'type': 'COCOStuff', 'size': 128, 'labels': [1],
                         'dataset_path': 'jpgs'}
    with open(cfg, 'w') as f:
        yaml.safe_dump(config, f)
    with pytest.raises(ValueError, match='masks'):
        patchgan_eval(['-c', cfg] + CLI_ARGS)
    partial = _save_generator(eval_dir / 'p.npz', 1, encoder_only=True)
    with pytest.raises(ValueError, match='7/14'):
        patchgan_eval(['-c', _eval_config(eval_dir, 1, partial)] + CLI_ARGS)
    with pytest.raises(ValueError, match='checkpoint_path'):
        patchgan_eval(['-c', _eval_config(eval_dir, 1)] + CLI_ARGS)
