"""The port's ``patchgan_infer`` against the JAX package's on the same
npz-plugin folder and checkpoint: masks agree on >= 99.9% of pixels.
``-d cuda`` / ``-d auto`` without a GPU raise."""

import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from patchgan_tpu.cli.infer import patchgan_infer as jax_infer
from patchgan_tpu_torch.cli.infer import patchgan_infer
from patchgan_tpu_torch.models import UNet
from patchgan_tpu_torch.utils.checkpoint import save_state_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 3


@pytest.fixture
def infer_dir(tmp_path, monkeypatch):
    shutil.copy(os.path.join(ROOT, 'examples', 'io_plugin_example.py'),
                tmp_path / 'io.py')
    data = tmp_path / 'data'
    data.mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(200, 150), (160, 300)]):
        np.savez(data / f'{i:03d}.npz',
                 image=rng.random((h, w, 3), dtype=np.float32),
                 labels=np.zeros((h, w), np.int32))
    model = UNet(3, CLASSES, nf=8, activation='relu', final_act='softmax',
                 generator=torch.Generator().manual_seed(1))
    save_state_dict(str(tmp_path / 'gen.npz'), model.state_dict())
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _config(root, out):
    cfg = {
        'dataset': {'type': 'NpzSegmentationDataset', 'size': 128,
                    'dataset_path': str(root / 'data'), 'in_channels': 3,
                    'out_channels': CLASSES},
        'model_params': {'gen_filts': 8, 'activation': 'relu',
                         'final_activation': 'softmax'},
        'checkpoint_paths': {'generator': str(root / 'gen.npz')},
        'infer_params': {'output_path': str(root / out), 'overlap': 0.9},
    }
    path = root / f'{out}.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_infer_cli_matches_jax(infer_dir):
    patchgan_infer(['-c', _config(infer_dir, 'port'), '-d', 'cpu',
                    '--dtype', 'float32', '--dataloader_workers', '1'])
    jax_infer(['-c', _config(infer_dir, 'jax'), '-d', 'cpu',
               '--dtype', 'float32', '--dataloader_workers', '1'])
    for i, (h, w) in enumerate([(200, 150), (160, 300)]):
        got = np.load(infer_dir / 'port' / f'{i:03d}.npy')
        want = np.load(infer_dir / 'jax' / f'{i:03d}.npy')
        assert got.shape == (h, w) == want.shape
        assert got.min() >= 0 and got.max() < CLASSES
        assert np.mean(got == want) >= 0.999


@pytest.mark.parametrize('device', ['cuda', 'auto'])
def test_infer_cli_without_gpu_raises(infer_dir, device, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='-d cpu'):
        patchgan_infer(['-c', _config(infer_dir, 'x'), '-d', device])


def test_infer_cli_rejects_partial_checkpoint(infer_dir, tmp_path):
    model = UNet(3, CLASSES, nf=8)
    sd = {k: v for k, v in model.state_dict().items() if 'encoder' in k}
    save_state_dict(str(tmp_path / 'gen.npz'), sd)
    with pytest.raises(ValueError, match='7/14'):
        patchgan_infer(['-c', _config(infer_dir, 'x'), '-d', 'cpu'])
