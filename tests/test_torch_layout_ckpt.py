"""Checkpoints of a channels_last Trainer (``train/auto_layout.py``).

Its epoch ``.npz`` files hold the same keys, shapes and C-order bytes as
an NCHW Trainer's (the ``.contiguous()`` of its parameters); the JAX
Trainer resumes them, and a channels_last Trainer resumes the JAX
Trainer's; a run with the generator's shadow cut mid-epoch and resumed
equals the uninterrupted run bit for bit in both exact-resume stores
(``.pt`` and ``checkpoint_format = 'orbax'``); ``patchgan_aot --shadow``
on the CPU.
"""

import json
import os
import zipfile

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
from patchgan_tpu_torch.train.auto_layout import LAYOUT
from patchgan_tpu_torch.utils.transfer import state_dict_from_jax
from test_torch_resume import (Preemptible, assert_same_epoch_files,
                               assert_same_state, synth_batches)

torch.set_num_threads(2)

NF, SIZE = 4, 128
CL = torch.channels_last


@pytest.fixture
def layout_on(monkeypatch):
    monkeypatch.setenv('PATCHGAN_AUTO_LAYOUT', 'on')
    monkeypatch.setenv('PATCHGAN_SHADOW_PARAMS', 'on')
    monkeypatch.setenv('PATCHGAN_S2D', 'off')


def port_trainer(folder, dtype=torch.float32, seed=3):
    gen = UNet(3, 1, nf=NF, activation='tanh', final_act='sigmoid',
               use_dropout=True, dtype=dtype,
               generator=torch.Generator().manual_seed(1))
    disc = Discriminator(4, ndf=NF, n_layers=2, dtype=dtype,
                         generator=torch.Generator().manual_seed(2))
    return Trainer(gen, disc, str(folder), seed=seed)


def jax_trainer(folder):
    gen = JaxUNet(input_nc=3, output_nc=1, nf=NF, final_act='sigmoid',
                  use_pallas=False)
    disc = JaxDisc(input_nc=4, ndf=NF, n_layers=2, use_pallas=False)
    return JaxTrainer(gen, disc, str(folder),
                      mesh=default_mesh(jax.devices()[:1]))


def npz_headers(path):
    """{key: (fortran_order, shape, dtype)} from each member's header."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as f:
                version = np.lib.format.read_magic(f)
                shape, fortran, dtype = \
                    np.lib.format._read_array_header(f, version)
            out[name[:-len('.npy')]] = (fortran, shape, dtype)
    return out


def test_epoch_files_hold_c_order_bytes(tmp_path, layout_on):
    t = port_trainer(tmp_path)
    assert t.layout == LAYOUT
    t.train(synth_batches(5, n_batches=2), [], epochs=1, save_freq=1)
    for module, prefix in ((t.generator, 'generator'),
                           (t.discriminator, 'discriminator')):
        path = tmp_path / f'{prefix}_ep_001.npz'
        state = module.state_dict()
        assert any(v.dim() == 4 and not v.is_contiguous()
                   for v in state.values())
        headers = npz_headers(path)
        with np.load(path) as data:
            assert sorted(data.files) == sorted(state)
            for k, v in state.items():
                want = v.detach().float().contiguous().numpy()
                assert headers[k] == (False, tuple(v.shape),
                                      np.dtype('<f4'))
                assert data[k].tobytes() == want.tobytes()


def _same_weights(jax_state, port):
    g = state_dict_from_jax(jax.device_get(jax_state.g_params))
    d = state_dict_from_jax(jax.device_get(jax_state.d_params))
    for want, module in ((g, port.generator), (d, port.discriminator)):
        got = module.state_dict()
        assert set(want) == set(got)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_jax_resumes_a_channels_last_folder(tmp_path, monkeypatch,
                                            layout_on):
    data = synth_batches(6, n_batches=2)
    pt = port_trainer(tmp_path)
    assert pt.layout == LAYOUT
    pt.train(data, [], epochs=1, save_freq=1)
    # the JAX Trainer's plain step
    monkeypatch.setenv('PATCHGAN_AUTO_LAYOUT', 'off')
    jt = jax_trainer(tmp_path)
    jt.load_last_checkpoint()
    assert jt.start == 2
    _same_weights(jt.state, pt)
    jt.train([(x.permute(0, 2, 3, 1).numpy(), y.permute(0, 2, 3, 1).numpy())
              for x, y in data], [], epochs=2, save_freq=1)
    assert os.path.exists(tmp_path / 'generator_ep_002.npz')


def test_channels_last_trainer_resumes_a_jax_folder(tmp_path, monkeypatch):
    monkeypatch.setenv('PATCHGAN_AUTO_LAYOUT', 'off')
    monkeypatch.setenv('PATCHGAN_S2D', 'off')
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    y = (rng.uniform(size=(2, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
    jt = jax_trainer(tmp_path)
    jt.train([(x, y)], [], epochs=1, save_freq=1)
    monkeypatch.setenv('PATCHGAN_AUTO_LAYOUT', 'on')
    pt = port_trainer(tmp_path, dtype=torch.bfloat16)
    assert (pt.layout, pt.shadow_dtype) == (LAYOUT, torch.bfloat16)
    pt.load_last_checkpoint()
    assert pt.start == 2
    _same_weights(jt.state, pt)
    assert all(p.is_contiguous(memory_format=CL)
               for p in pt.generator.parameters() if p.dim() == 4)
    pt.train([(torch.from_numpy(np.transpose(x, (0, 3, 1, 2))),
               torch.from_numpy(np.transpose(y, (0, 3, 1, 2))))], [],
             epochs=2, save_freq=1)
    shadows = pt._step_cache[2][False][0].shadows
    named = dict(pt.generator.named_parameters())
    assert all(torch.equal(s, named[n].detach().to(torch.bfloat16))
               for n, s in shadows.items())


@pytest.mark.parametrize('fmt', ['msgpack', 'orbax'])
def test_shadow_run_cut_and_resumed_equals_uninterrupted(tmp_path, fmt,
                                                         layout_on):
    """A bf16 channels_last run with the shadow, killed after 3 batches
    of epoch 1 with a rolling save after every batch, resumed by a new
    Trainer (another seed): its state and epoch-2 files equal the
    uninterrupted run's bit for bit, in either store."""
    batches = synth_batches(74, n_batches=3)

    def trainer(folder, seed=3):
        t = port_trainer(folder, dtype=torch.bfloat16, seed=seed)
        t.checkpoint_format = fmt
        assert (t.layout, t.shadow_dtype) == (LAYOUT, torch.bfloat16)
        return t

    ref = trainer(tmp_path / 'a')
    ref.train(list(batches), batches[:1], epochs=2, save_freq=1)
    pre = trainer(tmp_path / 'b')
    pre.save_every_steps = 1
    with pytest.raises(KeyboardInterrupt):
        pre.train(Preemptible(batches, fail_at=3), batches[:1], epochs=2,
                  save_freq=1)
    with open(tmp_path / 'b' / 'step_state_torch.json') as f:
        assert json.load(f)['state'].endswith(
            '.dcp' if fmt == 'orbax' else '.pt')
    cont = trainer(tmp_path / 'b', seed=999)
    cont.load_last_checkpoint()
    assert (cont.start, cont._resume_skip_batches) == (1, 2)
    cont.train(list(batches), batches[:1], epochs=2, save_freq=1)
    assert_same_state(ref, cont)
    assert_same_epoch_files(tmp_path / 'a', tmp_path / 'b', 2)
    for t in (ref, cont):
        assert all(p.is_contiguous(memory_format=CL)
                   for p in t.generator.parameters() if p.dim() == 4)


@pytest.mark.parametrize('layout', ['on', 'off'])
def test_aot_shadow_on_the_cpu(monkeypatch, capsys, layout):
    from patchgan_tpu_torch.cli.aot import patchgan_aot
    monkeypatch.setenv('PATCHGAN_AUTO_LAYOUT', layout)
    monkeypatch.setenv('PATCHGAN_S2D', 'off')
    result = patchgan_aot(['-d', 'cpu', '--dtype', 'float32', '--shadow',
                           '--gen-filts', '4', '--disc-filts', '4',
                           '--batch', '2', '--size', str(SIZE)])
    out = capsys.readouterr().out
    printed = json.loads(out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(result))
    assert result['compile_ok'] and result['shadow']
    assert f"layout {'channels_last' if layout == 'on' else 'nchw'}" in out
    with pytest.raises(ValueError, match='--shadow under --tp'):
        patchgan_aot(['-d', 'cpu', '--shadow', '--tp', '2'])
