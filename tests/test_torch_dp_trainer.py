"""The port's Trainer and CLIs under data parallelism on the CPU (gloo):
two spawned ranks train two epochs with the plateau schedule, the
rolling exact-resume state and flips and dropout on; only rank 0
writes, both ranks hold the same LR and schedule state, a run stopped
mid-epoch and resumed ends bit-equal to an uninterrupted one, and the
JAX Trainer resumes from the npz files. Then the CLIs: ``patchgan_train``
under ``torch.distributed.run --nproc_per_node 2``, a global ``-b`` that
does not divide across the ranks, ``patchgan_aot --dp 2``, and
``patchgan_infer`` / ``patchgan_serve`` under several ranks, which
raise (ROADMAP.md item 11b)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import torch_dp_worker as dpw

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH_FILES = ['discriminator_ep_001.npz', 'discriminator_ep_002.npz',
               'generator_ep_001.npz', 'generator_ep_002.npz',
               'step_state_torch.json', 'training_state_step_a.pt',
               'training_state_step_b.pt']


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp('trainer')
    dpw.launch(dpw.trainer_runs, 2, out)
    return out, [torch.load(out / f'trainer_{r}.pt', weights_only=False)
                 for r in range(2)]


def test_only_rank_0_writes(runs):
    out, ranks = runs
    assert sorted(os.listdir(out / 'whole')) == EPOCH_FILES
    assert ranks[1]['writes'] == []
    # G and D of epochs 1 and 2, epoch 1 of the cut run and its resume
    assert len(ranks[0]['writes']) == 2 * 2 + 2 + 2
    assert not any(f.endswith('.tmp') for f in os.listdir(out / 'cut'))


def test_ranks_hold_the_same_lr_and_losses(runs):
    """The plateau schedule reads the global validation means, so the
    ranks' schedules, LRs and loss histories agree exactly."""
    _, (r0, r1) = runs
    assert r0['lr'] == r1['lr']
    assert r0['schedules'] == r1['schedules']
    assert r0['history'] == r1['history']
    assert np.isfinite(r0['history']).all()
    assert r0['schedules'][0]['best'] < float('inf')


def test_resumed_run_is_bit_equal(runs):
    """Stopped when asking for epoch 2's second batch, resumed from the
    rolling state (epoch 2, one batch done) on every rank: the epoch-2
    files equal the uninterrupted run's bit for bit."""
    out, ranks = runs
    assert all(r['resumed_at'] == (2, 1) for r in ranks)
    for name in ('generator_ep_002.npz', 'discriminator_ep_002.npz'):
        a, b = np.load(out / 'whole' / name), np.load(out / 'cut' / name)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_jax_trainer_resumes_from_the_dp_files(runs, monkeypatch):
    from patchgan_tpu.models import Discriminator as JaxDisc
    from patchgan_tpu.models import UNet as JaxUNet
    from patchgan_tpu.train import Trainer as JaxTrainer
    from patchgan_tpu_torch.utils.transfer import state_dict_from_jax
    monkeypatch.setenv('PATCHGAN_AUTO_LAYOUT', 'off')
    out, _ = runs
    folder = out / 'jax'
    shutil.copytree(out / 'whole', folder)
    jt = JaxTrainer(JaxUNet(input_nc=3, output_nc=dpw.OUT_C, nf=dpw.NF,
                            use_pallas=False),
                    JaxDisc(input_nc=3 + dpw.OUT_C, ndf=dpw.NF, n_layers=3,
                            use_pallas=False), str(folder))
    jt.load_last_checkpoint()
    assert jt.start == 3
    import jax
    got = state_dict_from_jax(jax.device_get(jt.state.g_params))
    want = np.load(folder / 'generator_ep_002.npz')
    for k in want.files:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# the CLIs


@pytest.fixture
def train_dir(tmp_path, monkeypatch):
    """The npz plugin's folder layout at 128 px: 8 training and 4
    validation images of 3 labels."""
    shutil.copy(os.path.join(ROOT, 'examples', 'io_plugin_example.py'),
                tmp_path / 'io.py')
    rng = np.random.default_rng(62)
    for split, n in (('train', 8), ('val', 4)):
        (tmp_path / split).mkdir()
        for i in range(n):
            np.savez(tmp_path / split / f'{i:03d}.npz',
                     image=rng.random((128, 128, 3), dtype=np.float32),
                     labels=rng.integers(1, 4, (128, 128)).astype(np.int32))
    cfg = {
        'dataset': {'type': 'NpzSegmentationDataset', 'size': 128,
                    'in_channels': 3, 'out_channels': 3, 'labels': [1, 2, 3],
                    'train_data': {'images': 'train', 'masks': 'train'},
                    'validation_data': {'images': 'val', 'masks': 'val'}},
        'model_params': {'generator': {'filters': 4},
                         'discriminator': {'filters': 4, 'n_layers': 3}},
        'checkpoint_path': 'ck',
        'train_params': {'loss_type': 'tversky', 'seg_alpha': 200,
                         'gen_learning_rate': 1e-3,
                         'disc_learning_rate': 1e-3, 'save_freq': 1}}
    (tmp_path / 'train.yaml').write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    return tmp_path


ARGS = ['-c', 'train.yaml', '-n', '1', '-d', 'cpu', '--dtype', 'float32',
        '--no-summary', '--dataloader_workers', '0']


def test_train_cli_under_torchrun(train_dir):
    """Two gloo ranks, -b 4 (2 a rank): one epoch, one set of files,
    which a single-process Trainer loads."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train import Trainer
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get(
        'PYTHONPATH', ''), OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--nnodes', '1',
         '--nproc_per_node', '2', '--master_addr', '127.0.0.1',
         '--master_port', str(dpw.free_port()), '-m',
         'patchgan_tpu_torch.cli.train'] + ARGS + ['-b', '4'],
        cwd=train_dir, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert 'rank 1 of 2' in proc.stdout and 'Epoch 1 --' in proc.stdout
    assert proc.stdout.count('Epoch 1 --') == 1   # rank 0 prints it
    assert sorted(os.listdir(train_dir / 'ck')) == [
        'discriminator_ep_001.npz', 'generator_ep_001.npz']
    t = Trainer(UNet(3, 3, nf=4), Discriminator(6, ndf=4, n_layers=3),
                str(train_dir / 'ck'))
    t.load_last_checkpoint()
    assert t.start == 2


def test_train_cli_batch_must_divide(train_dir, monkeypatch):
    from patchgan_tpu_torch.cli.train import patchgan_train
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setenv('RANK', '0')
    with pytest.raises(ValueError, match='-b 3 .* 2 ranks'):
        patchgan_train(ARGS + ['-b', '3'])


def test_aot_reports_per_rank_numbers(tmp_path, capsys):
    """--dp 2 at a global batch of 4: the step at 2 a rank, half the
    FLOPs of --dp 1 a device, and the bucket and its ring bound."""
    from patchgan_tpu_torch.cli.aot import patchgan_aot
    flags = ['--gen-filts', '4', '--disc-filts', '4', '--batch', '4',
             '--size', '128', '-d', 'cpu', '--dtype', 'float32', '--no-s2d']
    one = patchgan_aot(flags)
    two = patchgan_aot(flags + ['--dp', '2'])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(two))
    assert (two['devices'], two['mesh'], two['batch']) == \
        (2, {'data': 2, 'model': 1}, 4)
    assert two['cost']['flops_per_device'] * 2 == \
        one['cost']['flops_per_device']
    assert two['cost']['img_per_s_ceiling'] == \
        pytest.approx(2 * one['cost']['img_per_s_ceiling'])
    line, = [l for l in out.splitlines() if 'gradient all-reduce' in l]
    from patchgan_tpu_torch.models import Discriminator, UNet
    values = sum(p.numel() for m in (UNet(3, 1, nf=4),
                                     Discriminator(4, ndf=4, n_layers=3))
                 for p in m.parameters())
    assert f'{values} fp32 values' in line
    ring = 2 * (2 - 1) / 2 * 4 * values
    assert f'{ring / 450e9 * 1e3:.3f} ms' in line


@pytest.mark.parametrize('cli', ['infer', 'serve'])
def test_engine_clis_refuse_several_ranks(cli, monkeypatch):
    from patchgan_tpu_torch.cli.infer import patchgan_infer
    from patchgan_tpu_torch.cli.serve import patchgan_serve
    monkeypatch.setenv('WORLD_SIZE', '2')
    args = ['-c', 'none.yaml', '-d', 'cpu'] + \
        (['--watch', 'x'] if cli == 'serve' else [])
    with pytest.raises(NotImplementedError,
                       match='already uses every visible card'):
        (patchgan_infer if cli == 'infer' else patchgan_serve)(args)
