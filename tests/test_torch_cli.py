"""The port's ``patchgan_infer`` against the JAX package's on the same
npz-plugin folder and checkpoint: masks agree on >= 99.9% of pixels;
its spatial mode writes the engine's spatial masks.
The port's ``patchgan_train`` on an npz-plugin folder: it trains, writes
checkpoints the JAX package reads, and resumes; it fine-tunes from
torch ``.pth`` checkpoints with the encoder frozen and accumulated
gradients; on a COCO folder it trains with the RAM cache, from tar
shards, with process workers, a profile and rolling checkpoints;
``spatial_parallelism`` that does not divide the world size raises.
``-d cuda`` / ``-d auto`` without a GPU raise."""

import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from patchgan_tpu.cli.infer import patchgan_infer as jax_infer
from patchgan_tpu_torch.cli.infer import patchgan_infer
from patchgan_tpu_torch.cli.train import patchgan_train
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


def test_infer_cli_spatial_mode(infer_dir):
    """infer_params.mode: spatial writes the masks that
    engine.predict_image(mode='spatial') gives."""
    from patchgan_tpu_torch.cli.serve import _build_engine
    path = _config(infer_dir, 'spatial')
    cfg = yaml.safe_load(open(path))
    cfg['infer_params']['mode'] = 'spatial'
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    patchgan_infer(['-c', path, '-d', 'cpu', '--dtype', 'float32',
                    '--dataloader_workers', '1'])
    engine, mode, _ = _build_engine(cfg, torch.float32, torch.device('cpu'))
    assert mode == 'spatial'
    for i, (h, w) in enumerate([(200, 150), (160, 300)]):
        image = np.load(infer_dir / 'data' / f'{i:03d}.npz')['image']
        got = np.load(infer_dir / 'spatial' / f'{i:03d}.npy')
        want = engine.predict_image(image, mode='spatial')
        assert got.shape == (h, w) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


class _Built(Exception):
    """Raised by the engine stubs below once the CLI has resolved where
    its engine runs."""


@pytest.mark.parametrize('device,want', [
    ('cuda', ('cuda:0', ['cuda:0', 'cuda:1', 'cuda:2', 'cuda:3'])),
    ('auto', ('cuda:0', ['cuda:0', 'cuda:1', 'cuda:2', 'cuda:3'])),
    ('cuda:1', ('cuda:1', None)),
    ('cpu', ('cpu', None))])
@pytest.mark.parametrize('cli', ['infer', 'serve'])
def test_engine_clis_resolve_the_mesh(infer_dir, monkeypatch, capsys, cli,
                                      device, want):
    """-d cuda / auto: one engine over every visible card (four here, by
    the monkeypatched count); -d cuda:N that card alone; -d cpu no mesh.
    The engine stub stops the CLI before any tensor reaches a card."""
    from patchgan_tpu_torch.cli import infer, serve
    if device != 'cpu':
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
        monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    seen = {}

    def stub(*args, device=None, mesh=None, **kwargs):
        seen['device'], seen['mesh'] = device, mesh
        raise _Built

    monkeypatch.setattr(infer, 'InferenceEngine', stub)
    monkeypatch.setattr('patchgan_tpu_torch.inference.InferenceEngine',
                        stub)
    args = ['-c', _config(infer_dir, 'x'), '-d', device]
    with pytest.raises(_Built):
        if cli == 'infer':
            infer.patchgan_infer(args)
        else:
            serve.patchgan_serve(args + ['--watch', str(infer_dir)])
    mesh = seen['mesh']
    assert (str(seen['device']),
            mesh and [str(d) for d in mesh]) == want
    if mesh is not None and cli == 'infer':
        assert 'Running on 4 devices: cuda:0..cuda:3' in \
            capsys.readouterr().out


def test_infer_cli_rejects_partial_checkpoint(infer_dir, tmp_path):
    model = UNet(3, CLASSES, nf=8)
    sd = {k: v for k, v in model.state_dict().items() if 'encoder' in k}
    save_state_dict(str(tmp_path / 'gen.npz'), sd)
    with pytest.raises(ValueError, match='7/14'):
        patchgan_infer(['-c', _config(infer_dir, 'x'), '-d', 'cpu'])


TRAIN_CLASSES = 3


@pytest.fixture
def train_dir(tmp_path, monkeypatch):
    shutil.copy(os.path.join(ROOT, 'examples', 'io_plugin_example.py'),
                tmp_path / 'io.py')
    rng = np.random.default_rng(60)
    for split, n in (('train', 4), ('val', 2)):
        (tmp_path / split).mkdir()
        for i in range(n):
            np.savez(tmp_path / split / f'{i:03d}.npz',
                     image=rng.random((128, 128, 3), dtype=np.float32),
                     labels=rng.integers(1, 4, (128, 128)).astype(np.int32))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _train_config(root, **extra):
    cfg = {
        'dataset': {'type': 'NpzSegmentationDataset', 'size': 128,
                    'in_channels': 3, 'out_channels': TRAIN_CLASSES,
                    'labels': [1, 2, 3],
                    'train_data': {'images': 'train', 'masks': 'train'},
                    'validation_data': {'images': 'val', 'masks': 'val'}},
        'model_params': {'generator': {'filters': 4, 'activation': 'relu',
                                       'final_activation': 'softmax'},
                         'discriminator': {'filters': 4, 'n_layers': 3}},
        'checkpoint_path': 'ck',
        'train_params': {'loss_type': 'tversky', 'seg_alpha': 200,
                         'gen_learning_rate': 1e-3,
                         'disc_learning_rate': 1e-3, 'save_freq': 1,
                         'decay_rate': 0.5},
    }
    for key, value in extra.items():
        section, _, name = key.partition('.')
        if name:
            cfg[section][name] = value
        else:
            cfg[key] = value
    path = root / 'train.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


TRAIN_ARGS = ['-d', 'cpu', '--dtype', 'float32', '-b', '2', '--no-summary',
              '--dataloader_workers', '1']


def test_train_cli_trains_saves_and_resumes(train_dir, capsys):
    """The npz plugin at 128 px, nf 4: two epochs write both checkpoint
    files each, the JAX package loads them, and a resume with
    load_last_checkpoint starts at epoch 3 with lr 1e-3 * 0.5 ** 0.4."""
    from patchgan_tpu.utils.checkpoint import load_state_dict
    from patchgan_tpu.utils.transfer import disc_key_map, unet_key_map
    g_hist, d_hist = patchgan_train(['-c', _train_config(train_dir), '-n',
                                     '2'] + TRAIN_ARGS)
    assert len(g_hist) == 2 and np.isfinite(g_hist + d_hist).all()
    for ep in (1, 2):
        gen = load_state_dict(str(train_dir / f'ck/generator_ep_{ep:03d}'
                                  '.npz'))
        disc = load_state_dict(str(train_dir / 'ck/discriminator_ep_'
                                   f'{ep:03d}.npz'))
        assert set(gen) == set(unet_key_map())
        assert set(disc) == set(disc_key_map(3, False))
    capsys.readouterr()
    g_hist, _ = patchgan_train(['-c', _train_config(
        train_dir, load_last_checkpoint=True), '-n', '3'] + TRAIN_ARGS)
    out = capsys.readouterr().out
    assert len(g_hist) == 1 and 'Epoch 3 -- lr: 7.579e-04' in out
    assert (train_dir / 'ck' / 'generator_ep_003.npz').exists()


@pytest.mark.parametrize('device', ['cuda', 'auto'])
def test_train_cli_without_gpu_raises(train_dir, device, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='-d cpu'):
        patchgan_train(['-c', _train_config(train_dir), '-n', '1', '-d',
                        device])


@pytest.mark.parametrize('extra,args', [
    ({'train_params.spatial_parallelism': 2}, []),
], ids=['spatial'])
def test_train_cli_deferred_keys_raise(train_dir, extra, args):
    """One process is a world of 1, which spatial_parallelism 2 does not
    divide: ValueError naming both, before any group forms (the JAX CLI's
    rule for its devices, ``patchgan_tpu/cli/train.py:112-115``)."""
    with pytest.raises(ValueError,
                       match='spatial_parallelism 2 .*world size 1'):
        patchgan_train(['-c', _train_config(train_dir, **extra), '-n',
                        '1'] + TRAIN_ARGS + args)


def test_train_cli_process_workers_refuse_a_plugin(train_dir):
    """The cwd io.py plugin's classes cannot be unpickled by a worker
    process: the loader says so (the JAX loader raises a bare
    PicklingError)."""
    with pytest.raises(ValueError, match='io.py'):
        patchgan_train(['-c', _train_config(train_dir), '-n', '1',
                        '--dataloader_worker_type', 'process'] + TRAIN_ARGS)


@pytest.fixture
def coco_train_dir(tmp_path, monkeypatch):
    """Four 128-px JPEG / PNG pairs as a folder and as two tar shards."""
    import tarfile

    from PIL import Image
    rng = np.random.default_rng(61)
    for name in ('images', 'masks', 'shards'):
        (tmp_path / name).mkdir()
    for i in range(4):
        Image.fromarray((rng.uniform(size=(128, 128, 3)) * 255)
                        .astype(np.uint8)).save(tmp_path / 'images'
                                                / f'{i:04d}.jpg')
        Image.fromarray(rng.integers(0, 3, (128, 128)).astype(np.uint8),
                        mode='L').save(tmp_path / 'masks' / f'{i:04d}.png')
    for si in range(2):
        with tarfile.open(tmp_path / 'shards' / f's-{si}.tar', 'w') as tf:
            for i in (2 * si, 2 * si + 1):
                tf.add(tmp_path / 'images' / f'{i:04d}.jpg',
                       arcname=f'{i:04d}.jpg')
                tf.add(tmp_path / 'masks' / f'{i:04d}.png',
                       arcname=f'{i:04d}.png')
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize('extra,args', [
    ({'dataset.cache': True}, []),
    ({'dataset.type': 'TarShards',
      'dataset.train_data': {'images': 'shards/s-*.tar', 'masks': None},
      'dataset.validation_data': {'images': 'shards/s-1.tar',
                                  'masks': None}}, []),
    ({}, ['--dataloader_worker_type', 'process']),
    ({}, ['--profile_dir', 'trace']),
    ({'train_params.save_every_steps': 1}, []),
], ids=['cache', 'tarshards', 'process', 'profile', 'save_every_steps'])
def test_train_cli_input_options_run(coco_train_dir, extra, args):
    """Each input-pipeline and resume option on a COCO folder, 2 epochs:
    finite losses and both epochs' files; the profile traces epoch 1
    only; the rolling metadata ends at "epoch 3, nothing done"."""
    import glob
    import json
    folder = {'images': 'images', 'masks': 'masks'}
    extra = {'dataset.type': 'COCOStuff', 'dataset.train_data': folder,
             'dataset.validation_data': folder,
             'dataset.augmentation': 'randomcrop+flip', **extra}
    g_hist, d_hist = patchgan_train(['-c', _train_config(
        coco_train_dir, **extra), '-n', '2'] + TRAIN_ARGS + args)
    assert len(g_hist) == 2 and np.isfinite(g_hist + d_hist).all()
    for ep in (1, 2):
        assert (coco_train_dir / 'ck' / f'generator_ep_{ep:03d}.npz').exists()
    if '--profile_dir' in args:
        assert len(glob.glob('trace/trace_*.json')) == 1
    if 'train_params.save_every_steps' in extra:
        meta = json.loads((coco_train_dir / 'ck' / 'step_state_torch.json')
                          .read_text())
        assert (meta['epoch'], meta['batches_done'],
                meta['loader_epoch']) == (3, 0, 3)


@pytest.mark.parametrize('freeze', [{'freeze_encoder': True},
                                    {'freeze': ['enc0', 'dec6']}],
                         ids=['freeze_encoder', 'freeze'])
def test_train_cli_fine_tunes_from_pth(train_dir, freeze):
    """transfer_learn from torch.save'd .pth state_dicts, with the frozen
    parameters and accumulate_steps=2 (two batches, one update): the
    epoch file holds the .pth's frozen weights bit for bit and moved
    the others."""
    from patchgan_tpu_torch.models import Discriminator
    from patchgan_tpu_torch.train.steps import is_frozen
    from patchgan_tpu_torch.utils.checkpoint import load_state_dict
    gen = UNet(3, TRAIN_CLASSES, nf=4, activation='relu',
               final_act='softmax', generator=torch.Generator().manual_seed(5))
    torch.save(gen.state_dict(), 'g.pth')
    torch.save(Discriminator(6, ndf=4).state_dict(), 'd.pth')
    tl = {'generator_checkpoint': 'g.pth', 'discriminator_checkpoint': 'd.pth',
          **freeze}
    g_hist, d_hist = patchgan_train(['-c', _train_config(
        train_dir, transfer_learn=tl, **{'train_params.accumulate_steps': 2}),
        '-n', '1'] + TRAIN_ARGS)
    assert len(g_hist) == 1 and np.isfinite(g_hist + d_hist).all()
    patterns = ('enc',) if 'freeze_encoder' in freeze else ('enc0', 'dec6')
    saved = load_state_dict(str(train_dir / 'ck/generator_ep_001.npz'))
    for k, v in gen.state_dict().items():
        if is_frozen(k, patterns):
            assert torch.equal(saved[k], v), k
        elif not k.startswith(('encoder.6.', 'decoder.0.')):
            # (at 128 px enc6's 1x1 plane normalises to exactly 0, so
            # enc6 and dec0 take a zero gradient)
            assert not torch.equal(saved[k], v), k


def test_train_cli_s2d_trains_and_resumes(train_dir, monkeypatch, capsys):
    """Under PATCHGAN_S2D=on the CLI raises nothing: it trains two epochs
    in the s2d boundary form, resumes at epoch 3, and the JAX package's
    Trainer resumes from the epoch files it wrote, with the same
    weights."""
    import jax
    from patchgan_tpu.models import Discriminator as JaxDisc
    from patchgan_tpu.models import UNet as JaxUNet
    from patchgan_tpu.parallel.mesh import default_mesh
    from patchgan_tpu.train import Trainer as JaxTrainer
    from patchgan_tpu_torch.utils.checkpoint import load_state_dict
    from patchgan_tpu_torch.utils.transfer import state_dict_from_jax
    monkeypatch.setenv('PATCHGAN_S2D', 'on')
    g_hist, d_hist = patchgan_train(['-c', _train_config(train_dir), '-n',
                                     '2'] + TRAIN_ARGS)
    assert len(g_hist) == 2 and np.isfinite(g_hist + d_hist).all()
    capsys.readouterr()
    g_hist, _ = patchgan_train(['-c', _train_config(
        train_dir, load_last_checkpoint=True), '-n', '3'] + TRAIN_ARGS)
    assert len(g_hist) == 1 and 'Epoch 3 -- lr: 7.579e-04' in \
        capsys.readouterr().out
    monkeypatch.setenv('PATCHGAN_AUTO_LAYOUT', 'off')
    jt = JaxTrainer(JaxUNet(input_nc=3, output_nc=TRAIN_CLASSES, nf=4,
                            activation='relu', final_act='softmax',
                            use_pallas=False),
                    JaxDisc(input_nc=3 + TRAIN_CLASSES, ndf=4, n_layers=3,
                            use_pallas=False),
                    str(train_dir / 'ck'),
                    mesh=default_mesh(jax.devices()[:1]))
    jt.load_last_checkpoint()
    assert jt.start == 4
    for params, name in ((jt.state.g_params, 'generator'),
                         (jt.state.d_params, 'discriminator')):
        want = load_state_dict(str(train_dir / f'ck/{name}_ep_003.npz'))
        got = state_dict_from_jax(jax.device_get(params))
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
