"""The port's spatial parallelism in training (``patchgan_tpu_torch/
parallel/spatial.py``) on the CPU, end to end:

- the Trainer on a (2, 2) ``SpatialMesh`` of spawned gloo ranks
  (``tests/torch_sp_worker.py``) and ``patchgan_train`` with
  ``spatial_parallelism: 2`` on two ranks that see torchrun's environment;
- the refusals: the s2d form, ``sp`` not dividing the world, ``sp`` with
  ``mp``; the Trainer's one warning where H does not split.

The band operations and the step are in ``tests/test_torch_spatial.py``.
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch
import yaml

import torch_dp_worker as dpw
import torch_sp_worker as spw
import torch_tp_worker as tpw
from patchgan_tpu_torch.parallel.spatial import SpatialMesh

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the Trainer and the CLI


@pytest.fixture
def npz_dir(tmp_path):
    """An npz-plugin folder (io.py in it): 8 training and 4 validation
    pairs at 128 px, labels 1-3."""
    shutil.copy(os.path.join(ROOT, 'examples', 'io_plugin_example.py'),
                tmp_path / 'io.py')
    rng = np.random.default_rng(61)
    for split, n in (('train', 8), ('val', 4)):
        (tmp_path / split).mkdir()
        for i in range(n):
            np.savez(tmp_path / split / f'{i:03d}.npz',
                     image=rng.random((128, 128, 3), dtype=np.float32),
                     labels=rng.integers(1, 4, (128, 128)).astype(np.int32))
    return tmp_path


def test_trainer_on_a_2x2_spatial_mesh(npz_dir):
    """``Trainer(mesh=SpatialMesh)`` at (2, 2) trains one epoch: finite
    losses, every rank's parameters equal rank 0's after it, and the epoch
    files written once, by rank 0."""
    out = npz_dir / 'out'
    out.mkdir()
    spw.launch(spw.trainer_epoch, 2, 2, out, str(npz_dir))
    results = [torch.load(out / f'trainer_{r}.pt', weights_only=False)
               for r in range(4)]
    for r in results:
        assert r['replicated'] and r['step'] == 2
        assert np.isfinite(r['history']).all()
        assert r['history'] == results[0]['history']
    assert [len(r['writes']) for r in results] == [2, 0, 0, 0]
    assert sorted(os.listdir(out / 'ck')) == ['discriminator_ep_001.npz',
                                              'generator_ep_001.npz']


def test_train_cli_spatial_on_two_ranks(npz_dir):
    """``patchgan_train -d cpu`` with ``spatial_parallelism: 2`` on two
    ranks that see torchrun's environment: finite losses, the same on both
    ranks, "Spatial parallel: 1 x 2 ranks" printed by rank 0 alone, one set
    of epoch files."""
    cfg = {
        'dataset': {'type': 'NpzSegmentationDataset', 'size': 128,
                    'in_channels': 3, 'out_channels': 3, 'labels': [1, 2, 3],
                    'train_data': {'images': 'train', 'masks': 'train'},
                    'validation_data': {'images': 'val', 'masks': 'val'}},
        'model_params': {'generator': {'filters': 4},
                         'discriminator': {'filters': 4, 'n_layers': 3}},
        'checkpoint_path': str(npz_dir / 'ck'),
        'train_params': {'loss_type': 'tversky', 'seg_alpha': 200,
                         'gen_learning_rate': 1e-3,
                         'disc_learning_rate': 1e-3, 'save_freq': 1,
                         'spatial_parallelism': 2}}
    (npz_dir / 'train.yaml').write_text(yaml.safe_dump(cfg))
    argv = ['-c', str(npz_dir / 'train.yaml'), '-n', '1', '-d', 'cpu',
            '--dtype', 'float32', '-b', '4', '--no-summary',
            '--dataloader_workers', '0']
    out = npz_dir / 'out'
    out.mkdir()
    dpw.launch(spw.train_rank, 2, out, argv, str(npz_dir),
               main=tpw._aot_main)
    (h0, text0), (h1, text1) = [torch.load(out / f'train_{r}.pt',
                                           weights_only=False)
                                for r in range(2)]
    assert h0 == h1 and np.isfinite(h0).all()
    assert 'Spatial parallel: 1 x 2 ranks' in text0
    assert 'Spatial parallel' not in text1
    assert sorted(os.listdir(npz_dir / 'ck')) == [
        'discriminator_ep_001.npz', 'generator_ep_001.npz']


def _fake_mesh(sp):
    """A SpatialMesh as a rank sees it, for what needs no collective."""
    class Axis:
        size = sp
    mesh = object.__new__(SpatialMesh)
    mesh.spatial, mesh.rank, mesh.backend = Axis(), 0, 'gloo'
    mesh.shape = {'data': 1, 'spatial': sp}
    return mesh


def test_spatial_refuses_s2d_and_warns_once(tmp_path, monkeypatch):
    """``make_train_step`` and ``make_eval_step`` refuse the s2d form on a
    spatial mesh, and the Trainer runs the plain form there whatever
    PATCHGAN_S2D says (JAX ``trainer.py:237-245``); a batch whose height
    does not split into bands of an even number of rows warns once."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train import Trainer
    from patchgan_tpu_torch.train.steps import (make_eval_step,
                                                make_optimizer,
                                                make_train_step)
    gen, disc = UNet(3, 1, nf=4), Discriminator(4, ndf=4)
    mesh = _fake_mesh(3)
    opts = [make_optimizer(m.parameters()) for m in (gen, disc)]
    with pytest.raises(ValueError, match='plain form'):
        make_train_step(gen, disc, *opts, s2d=True, mesh=mesh)
    with pytest.raises(ValueError, match='plain form'):
        make_eval_step(gen, disc, s2d=True, mesh=mesh)
    monkeypatch.setenv('PATCHGAN_S2D', 'on')
    t = Trainer(gen, disc, str(tmp_path / 'ck'), device='cpu', mesh=mesh)
    x = np.zeros((2, 3, 128, 128), np.float32)
    assert not t._use_s2d(torch.from_numpy(x))
    with pytest.warns(UserWarning, match='keeps H whole'):
        t._place_batch(x, x)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        t._place_batch(x, x)


@pytest.mark.parametrize('world,sp', [('3', 2), ('4', 3)])
def test_train_cli_sp_must_divide_the_world(tmp_path, monkeypatch, world,
                                            sp):
    """``spatial_parallelism`` that does not divide torchrun's world size
    raises ValueError naming both, before any group forms."""
    from patchgan_tpu_torch.cli.train import patchgan_train
    for name in ('RANK', 'LOCAL_RANK'):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv('WORLD_SIZE', world)
    path = tmp_path / 'train.yaml'
    path.write_text(yaml.safe_dump({'train_params': {
        'spatial_parallelism': sp}}))
    with pytest.raises(ValueError, match=f'spatial_parallelism {sp} must '
                       f'divide the world size {world}'):
        patchgan_train(['-c', str(path), '-n', '1', '-d', 'cpu'])
    assert not torch.distributed.is_initialized()


def test_init_refuses_spatial_and_model_axes(monkeypatch):
    """``init_from_env`` with sp > 1 and mp > 1 raises ValueError (no mesh
    of either package has both axes), before any group forms."""
    from patchgan_tpu_torch.parallel import init_from_env
    monkeypatch.setenv('WORLD_SIZE', '4')
    with pytest.raises(ValueError, match='spatial axis'):
        init_from_env(on_cpu=True, mp=2, sp=2)
    assert not torch.distributed.is_initialized()
