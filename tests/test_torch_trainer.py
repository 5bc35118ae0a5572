"""Checkpoints carry across: the port's Trainer resumes from epoch files
a JAX Trainer wrote, and the other way round, at the next epoch with the
fast-forwarded learning rate (lr * decay ** ((start - 1) / decay_freq)),
a frozen, accumulated fine-tune's files too. The orbax checkpoint
format, not ported, raises."""

import os

import jax
import numpy as np
import pytest
import torch

from patchgan_tpu.models import Discriminator as JaxDisc
from patchgan_tpu.models import UNet as JaxUNet
from patchgan_tpu.parallel.mesh import default_mesh
from patchgan_tpu.train import Trainer as JaxTrainer
from patchgan_tpu_torch.models import Discriminator, UNet
from patchgan_tpu_torch.train import Trainer
from patchgan_tpu_torch.utils.transfer import state_dict_from_jax

torch.set_num_threads(2)

NF, SIZE = 4, 128
SCHEDULE = dict(save_freq=1, lr_decay=0.5, decay_freq=1)
# at 128 px enc6's plane is 1x1, so its normalised output is exactly 0:
# enc6 and dec0 take a zero gradient and never move
STILL = ('encoder.6.', 'decoder.0.')


@pytest.fixture
def jax_env(monkeypatch):
    # the plain single-device JAX step: no AUTO layouts, no s2d form
    monkeypatch.setenv('PATCHGAN_AUTO_LAYOUT', 'off')
    monkeypatch.setenv('PATCHGAN_S2D', 'off')


def _jax_trainer(folder):
    gen = JaxUNet(input_nc=3, output_nc=1, nf=NF, final_act='sigmoid',
                  use_pallas=False)
    disc = JaxDisc(input_nc=4, ndf=NF, n_layers=2, use_pallas=False)
    return JaxTrainer(gen, disc, str(folder),
                      mesh=default_mesh(jax.devices()[:1]))


def _port_trainer(folder):
    gen = UNet(3, 1, nf=NF, activation='tanh', final_act='sigmoid',
               use_dropout=True, generator=torch.Generator().manual_seed(1))
    disc = Discriminator(4, ndf=NF, n_layers=2,
                         generator=torch.Generator().manual_seed(2))
    return Trainer(gen, disc, str(folder), seed=3)


def _batches(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    y = (rng.uniform(size=(2, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
    return [(x, y)], [(torch.from_numpy(np.transpose(x, (0, 3, 1, 2))),
                       torch.from_numpy(np.transpose(y, (0, 3, 1, 2))))]


def _assert_same_weights(jax_state, port):
    g = state_dict_from_jax(jax.device_get(jax_state.g_params))
    d = state_dict_from_jax(jax.device_get(jax_state.d_params))
    for want, module in ((g, port.generator), (d, port.discriminator)):
        got = module.state_dict()
        assert set(want) == set(got)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_port_resumes_jax_checkpoint(tmp_path, jax_env, capsys):
    jax_data, port_data = _batches(50)
    jt = _jax_trainer(tmp_path)
    jt.train(jax_data, [], epochs=1, **SCHEDULE)
    pt = _port_trainer(tmp_path)
    pt.load_last_checkpoint()
    assert pt.start == 2
    _assert_same_weights(jt.state, pt)
    capsys.readouterr()
    g_hist, d_hist = pt.train(port_data, [], epochs=2, **SCHEDULE)
    assert "Epoch 2 -- lr: 5.000e-04, 5.000e-04" in capsys.readouterr().out
    assert len(g_hist) == 1 and np.isfinite(g_hist + d_hist).all()
    assert os.path.exists(tmp_path / 'generator_ep_002.npz')
    assert os.path.exists(tmp_path / 'discriminator_ep_002.npz')
    assert pt.start == 3


def test_jax_resumes_port_checkpoint(tmp_path, jax_env, capsys):
    jax_data, port_data = _batches(51)
    pt = _port_trainer(tmp_path)
    pt.train(port_data, port_data, epochs=1, **SCHEDULE)
    jt = _jax_trainer(tmp_path)
    jt.load_last_checkpoint()
    assert jt.start == 2
    _assert_same_weights(jt.state, pt)
    capsys.readouterr()
    g_hist, _ = jt.train(jax_data, [], epochs=2, **SCHEDULE)
    assert "Epoch 2 -- lr: 5.000e-04, 5.000e-04" in capsys.readouterr().out
    assert np.isfinite(g_hist).all()
    assert os.path.exists(tmp_path / 'generator_ep_002.npz')


@pytest.mark.parametrize('name,value', [('checkpoint_format', 'orbax')])
def test_unported_trainer_options_raise(tmp_path, name, value):
    pt = _port_trainer(tmp_path)
    setattr(pt, name, value)
    _, port_data = _batches(52)
    with pytest.raises(NotImplementedError, match=f'{name}.*ROADMAP'):
        pt.train(port_data, [], epochs=1)


def test_frozen_accumulated_fine_tune_resumes_across_packages(
        tmp_path, jax_env):
    """freeze_generator=('enc',) and accumulate_steps=2 in both Trainers:
    the port's epoch of two batches (one update) leaves the encoder
    bit-equal and moves the decoder; the JAX Trainer resumes its files
    with the same weights and fine-tunes a second epoch alike; the port
    resumes those, the encoder still the initial one."""
    jax_data, port_data = zip(*(_batches(s) for s in (54, 55)))
    jax_data, port_data = jax_data[0] + jax_data[1], \
        port_data[0] + port_data[1]
    pt = _port_trainer(tmp_path)
    init = {k: v.clone() for k, v in pt.generator.state_dict().items()}
    pt.freeze_generator, pt.accumulate_steps = ('enc',), 2
    pt.train(port_data, [], epochs=1, **SCHEDULE)
    _assert_only_unfrozen_moved(pt.generator.state_dict(), init)
    jt = _jax_trainer(tmp_path)
    jt.freeze_generator, jt.accumulate_steps = ('enc',), 2
    jt.load_last_checkpoint()
    assert jt.start == 2
    _assert_same_weights(jt.state, pt)
    jt.train(jax_data, [], epochs=2, **SCHEDULE)
    pt = _port_trainer(tmp_path)
    pt.load_last_checkpoint()
    assert pt.start == 3
    _assert_same_weights(jt.state, pt)
    _assert_only_unfrozen_moved(pt.generator.state_dict(), init)


def _assert_only_unfrozen_moved(now, init):
    for k, v in now.items():
        if k.startswith('encoder'):
            assert torch.equal(v, init[k]), k
        elif not k.startswith(STILL):
            assert not torch.equal(v, init[k]), k


def test_batch_keys_and_eval_leaves_weights(tmp_path):
    """batch() gives the reference's keys with gen == gen_loss; eval
    changes no weight, a train step changes them."""
    pt = _port_trainer(tmp_path)
    pt.compute_iou = True
    _, [(x, y)] = _batches(53)
    before = {k: v.clone() for k, v in pt.generator.state_dict().items()}
    losses = pt.batch(x, y, train=False)
    assert list(losses) == ['gen', 'gen_loss', 'gdisc', 'discr', 'discf',
                            'disc', 'iou']
    assert losses['gen'] == losses['gen_loss']
    assert all(np.isfinite(v) for v in losses.values())
    for k, v in pt.generator.state_dict().items():
        assert torch.equal(v, before[k])
    pt.batch(x, y, train=True)
    assert not torch.equal(pt.generator.state_dict()[
        'encoder.0.model.DownConv0.weight'],
        before['encoder.0.model.DownConv0.weight'])


def test_missing_checkpoint_starts_afresh(tmp_path, capsys):
    pt = _port_trainer(tmp_path)
    pt.load_last_checkpoint()
    assert pt.start == 1
    assert "Checkpoints not loaded" in capsys.readouterr().out


@pytest.mark.parametrize('cut', ['half', 'empty'])
def test_broken_checkpoint_starts_afresh(tmp_path, jax_env, capsys, cut):
    """A newest generator file cut short, as a run killed in the middle
    of a save leaves it, or empty: both Trainers print the error and
    start afresh at epoch 1."""
    pt = _port_trainer(tmp_path)
    pt.save(1)
    path = tmp_path / 'generator_ep_001.npz'
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2] if cut == 'half' else b'')
    capsys.readouterr()
    pt = _port_trainer(tmp_path)
    pt.load_last_checkpoint()
    assert pt.start == 1
    assert "Checkpoints not loaded" in capsys.readouterr().out
    jt = _jax_trainer(tmp_path)
    jt.load_last_checkpoint()
    assert jt.start == 1
    assert "Checkpoints not loaded" in capsys.readouterr().out
