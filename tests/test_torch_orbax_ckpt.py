"""The async exact-resume store, ``Trainer.checkpoint_format = 'orbax'``
(``utils/orbax_ckpt.py``, over ``torch.distributed.checkpoint``), as the
JAX package's tests hold its orbax store (``tests/test_trainer.py:214,
368, 478``): an epoch-state resume bit-equal to an uninterrupted run and
to the ``.pt`` store's resume; a preemption resume through the rolling
``.dcp`` slots; the slots never rewrite the live one; ``save_async``
keeps the state as it was at the call; a resume against the JAX
Trainer's orbax resume on the same batches; two gloo ranks where only
rank 0 writes and a state crosses world sizes bit for bit; a JAX
``.orbax`` directory noted and not read."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker as dpw
import torch_parity
from patchgan_tpu.models import Discriminator as JaxDisc
from patchgan_tpu.models import UNet as JaxUNet
from patchgan_tpu.parallel.mesh import default_mesh
from patchgan_tpu.train import Trainer as JaxTrainer
from patchgan_tpu_torch.models import Discriminator, UNet
from patchgan_tpu_torch.train import Trainer
from patchgan_tpu_torch.train.trainer import STEP_META
from patchgan_tpu_torch.utils import orbax_ckpt
from patchgan_tpu_torch.utils.transfer import state_dict_from_jax
from test_torch_resume import (Preemptible, assert_same_epoch_files,
                               assert_same_state, make_trainer,
                               synth_batches)

torch.set_num_threads(2)

NF, SIZE = 4, 128


def dcp_trainer(folder, seed=3, accumulate=1, mu_dtype=None):
    t = make_trainer(folder, seed=seed, accumulate=accumulate)
    t.checkpoint_format = 'orbax'
    t.adam_mu_dtype = mu_dtype
    return t


@pytest.mark.parametrize('accumulate,mu_dtype', [
    (1, None), (2, None), (1, torch.bfloat16)],
    ids=['adam', 'accumulate', 'mu-bf16'])
def test_epoch_state_resume_equals_uninterrupted(tmp_path, accumulate,
                                                 mu_dtype):
    """Epoch 1 saved through the store, a new Trainer (another seed)
    resumes and trains epoch 2: every tensor of the state equals the
    uninterrupted run's and the ``.pt`` store's resume, and so do the
    epoch-2 files."""
    data = synth_batches(90, n_batches=3)
    runs = {}
    for name, fmt in (('full', 'orbax'), ('dcp', 'orbax'), ('pt', 'msgpack')):
        t = dcp_trainer(tmp_path / name, accumulate=accumulate,
                        mu_dtype=mu_dtype)
        t.checkpoint_format, t.save_optimizer_state = fmt, True
        t.train(data, data[:1], epochs=1 if name != 'full' else 2,
                save_freq=1)
        if name != 'full':
            t = dcp_trainer(tmp_path / name, seed=999, accumulate=accumulate,
                            mu_dtype=mu_dtype)
            t.checkpoint_format, t.save_optimizer_state = fmt, True
            t.load_last_checkpoint()
            want = 'training_state_ep_001.' + ('dcp' if fmt == 'orbax'
                                               else 'pt')
            assert t.start == 2 and \
                os.path.basename(t._pending_training_state) == want
            t.train(data, data[:1], epochs=2, save_freq=1)
        runs[name] = t
    assert sorted(p for p in os.listdir(tmp_path / 'dcp')
                  if 'training_state' in p) == [
        'training_state_ep_001.dcp', 'training_state_ep_002.dcp']
    assert runs['dcp'].step == runs['full'].step == 6
    assert_same_state(runs['full'], runs['dcp'])
    assert_same_state(runs['pt'], runs['dcp'])
    assert_same_epoch_files(tmp_path / 'full', tmp_path / 'dcp', 2)


@pytest.mark.parametrize('accumulate,fail_at,done', [
    (1, 4, 3), (2, 4, 3), (2, 6, 1)],
    ids=['mid-epoch', 'mid-window', 'second-epoch'])
def test_preemption_resume_through_dcp(tmp_path, accumulate, fail_at, done):
    """Killed at the fail_at-th batch with a rolling save after every
    batch into the ``.dcp`` slots: the resume finishes bit for bit as the
    uninterrupted run."""
    batches = synth_batches(91)
    ref = dcp_trainer(tmp_path / 'a', accumulate=accumulate)
    ref.train(list(batches), batches[:1], epochs=2, save_freq=1)

    pre = dcp_trainer(tmp_path / 'b', accumulate=accumulate)
    pre.save_every_steps = 1
    with pytest.raises(KeyboardInterrupt):
        pre.train(Preemptible(batches, fail_at=fail_at), batches[:1],
                  epochs=2, save_freq=1)
    with open(tmp_path / 'b' / STEP_META) as f:
        assert json.load(f)['state'].endswith('.dcp')

    cont = dcp_trainer(tmp_path / 'b', seed=999, accumulate=accumulate)
    cont.load_last_checkpoint()
    assert cont.start == (1 if fail_at <= 4 else 2)
    assert cont._resume_skip_batches == done
    cont.train(list(batches), batches[:1], epochs=2, save_freq=1)
    assert_same_state(ref, cont)
    assert_same_epoch_files(tmp_path / 'a', tmp_path / 'b', 2)


@pytest.mark.parametrize('fmt', ['msgpack', 'orbax'])
def test_rolling_slots_never_rewrite_the_live_slot(tmp_path, fmt):
    """Every rolling save writes the slot the metadata does not name, the
    first save after a resume included, in both stores."""
    def live_slot():
        with open(tmp_path / STEP_META) as f:
            return json.load(f)['state']

    pre = make_trainer(tmp_path)
    pre.checkpoint_format, pre.save_every_steps = fmt, 1
    with pytest.raises(KeyboardInterrupt):
        pre.train(Preemptible(synth_batches(92), fail_at=3), [], epochs=1,
                  save_freq=10)
    first = live_slot()
    assert first.endswith('.dcp' if fmt == 'orbax' else '.pt')
    cont = make_trainer(tmp_path, seed=3)
    cont.checkpoint_format, cont.save_every_steps = fmt, 1
    cont.load_last_checkpoint()
    cont._save_step_state(1, 3)
    second = live_slot()
    assert first != second
    for name in (first, second):
        assert os.path.exists(tmp_path / name)
    assert not any(p.endswith('.tmp') for p in os.listdir(tmp_path))


def test_save_async_keeps_the_state_of_the_call(tmp_path):
    """Right after ``save_async`` returns, every parameter and moment is
    overwritten in place, as the next captured step does; after
    ``wait()`` a restore gives back the values of the call, bit for bit,
    into the live tensors."""
    t = make_trainer(tmp_path, accumulate=2)
    t._make_optimizers(1e-3, 1e-3)   # as train() builds them
    for x, y in synth_batches(93, 3):   # moments and accumulator not 0
        t.batch(x, y, train=True)
    saved = dpw.host_state(t)
    path = orbax_ckpt.orbax_path(t.savefolder, 7)
    orbax_ckpt.save_async(path, t.training_state())
    live = t.training_state()
    tensors, _ = orbax_ckpt._split(live)
    with torch.no_grad():
        for x in tensors.values():
            if x.is_floating_point():
                x.add_(1.0)
    orbax_ckpt.wait()
    assert sorted(os.listdir(path)) == ['.metadata', '__0_0.distcp',
                                        orbax_ckpt.SCALARS]
    template = t.training_state()
    restored = orbax_ckpt.restore(path, template)
    # in place: the restored tensors are the template's, the live ones
    assert all(a is b for a, b in zip(
        orbax_ckpt._split(restored)[0].values(),
        orbax_ckpt._split(template)[0].values()))
    first = next(iter(t.generator.parameters()))
    assert torch.equal(first, saved['generator'][next(iter(
        t.generator.state_dict()))])
    got = {k: v for k, v in orbax_ckpt._split(restored)[0].items()}
    want = orbax_ckpt._split(saved)[0]
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert orbax_ckpt._split(restored)[1] == orbax_ckpt._split(saved)[1]


def test_restore_refuses_another_structure(tmp_path):
    """A state saved with accumulation restores into no optimizer
    without it."""
    t = make_trainer(tmp_path, accumulate=2)
    t._make_optimizers(1e-3, 1e-3)
    path = orbax_ckpt.orbax_path(t.savefolder, 1)
    orbax_ckpt.save_async(path, t.training_state())
    other = make_trainer(tmp_path / 'x')
    with pytest.raises(ValueError, match='accumulate_steps'):
        orbax_ckpt.restore(path, other.training_state())


@pytest.fixture
def jax_env(monkeypatch):
    monkeypatch.setenv('PATCHGAN_AUTO_LAYOUT', 'off')
    monkeypatch.setenv('PATCHGAN_S2D', 'off')


def _jax_trainer(folder):
    gen = JaxUNet(input_nc=3, output_nc=1, nf=NF, final_act='sigmoid',
                  use_pallas=False)
    disc = JaxDisc(input_nc=4, ndf=NF, n_layers=2, use_pallas=False)
    return JaxTrainer(gen, disc, str(folder),
                      mesh=default_mesh(jax.devices()[:1]))


def test_resume_agrees_with_the_jax_orbax_resume(tmp_path, jax_env):
    """The JAX Trainer with ``checkpoint_format='orbax'`` and the port
    with its store, from the JAX package's weights (dropout off), each
    train epoch 1 (two batches), save, resume in a new Trainer and train
    epoch 2 on the same batches: the epoch-2 files agree within the G+D
    step's limits, and each resume took its own store's state."""
    rng = np.random.default_rng(94)
    x = rng.uniform(size=(2, 2, SIZE, SIZE, 3)).astype(np.float32)
    y = (rng.uniform(size=(2, 2, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
    jax_data = [(x[i], y[i]) for i in range(2)]
    port_data = [(torch_parity.nchw(a), torch_parity.nchw(b))
                 for a, b in jax_data]
    weights = None
    for epochs, seed in ((1, 0), (2, 5)):
        jt = _jax_trainer(tmp_path / 'jax')
        jt.checkpoint_format, jt.save_optimizer_state = 'orbax', True
        if weights is None:
            weights = (state_dict_from_jax(jax.device_get(jt.state.g_params)),
                       state_dict_from_jax(jax.device_get(jt.state.d_params)))
        else:
            jt.load_last_checkpoint()
            assert str(jt._pending_training_state).endswith('.orbax')
        jt.train(jax_data, [], epochs=epochs, save_freq=1)
        gen = UNet(3, 1, nf=NF, activation='tanh', final_act='sigmoid')
        disc = Discriminator(4, ndf=NF, n_layers=2)
        gen.load_state_dict(weights[0])
        disc.load_state_dict(weights[1])
        pt = Trainer(gen, disc, str(tmp_path / 'port'), seed=seed)
        pt.checkpoint_format, pt.save_optimizer_state = 'orbax', True
        if epochs == 2:
            pt.load_last_checkpoint()
            assert pt._pending_training_state.endswith(
                'training_state_ep_001.dcp')
        pt.train(port_data, [], epochs=epochs, save_freq=1)
    assert (tmp_path / 'jax' / 'training_state_ep_002.orbax').is_dir()
    assert (tmp_path / 'port' / 'training_state_ep_002.dcp').is_dir()
    for prefix in ('generator', 'discriminator'):
        name = f'{prefix}_ep_002.npz'
        with np.load(tmp_path / 'jax' / name) as a, \
                np.load(tmp_path / 'port' / name) as b:
            torch_parity.assert_params_close(
                {k: torch.from_numpy(a[k]) for k in a.files},
                {k: torch.from_numpy(b[k]) for k in b.files})


def test_port_notes_a_jax_orbax_directory(tmp_path, jax_env, capsys):
    """A JAX folder with ``training_state_ep_001.orbax/``: the port
    resumes from the epoch npz files with fresh moments, notes the
    directory and reads nothing of it."""
    rng = np.random.default_rng(95)
    x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    y = (rng.uniform(size=(2, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
    jt = _jax_trainer(tmp_path)
    jt.checkpoint_format, jt.save_optimizer_state = 'orbax', True
    jt.train([(x, y)], [], epochs=1, save_freq=1)
    assert (tmp_path / 'training_state_ep_001.orbax').is_dir()
    capsys.readouterr()
    pt = make_trainer(tmp_path)
    pt.checkpoint_format = 'orbax'
    pt.load_last_checkpoint()
    out = capsys.readouterr().out
    assert pt.start == 2 and pt._pending_training_state is None
    assert "training_state_ep_001.orbax is the JAX package's" in out
    g_hist, _ = pt.train(synth_batches(96, 1), [], epochs=2, save_freq=1)
    assert np.isfinite(g_hist).all()


# two gloo ranks


DCP_FILES = ['discriminator_ep_001.npz', 'discriminator_ep_002.npz',
             'generator_ep_001.npz', 'generator_ep_002.npz',
             'step_state_torch.json', 'training_state_ep_001.dcp',
             'training_state_ep_002.dcp', 'training_state_step_a.dcp',
             'training_state_step_b.dcp']


@pytest.fixture(scope='module')
def dcp_runs(tmp_path_factory):
    """One process's epoch-1 state saved into ``single``, then two ranks
    (``dpw.dcp_trainer_runs``), then one process restoring the ranks'
    ``whole`` folder."""
    out = tmp_path_factory.mktemp('dcp')
    single = dpw.single_dcp_run(str(out / 'single'))
    dpw.launch(dpw.dcp_trainer_runs, 2, out)
    ranks = [torch.load(out / f'dcp_{r}.pt', weights_only=False)
             for r in range(2)]
    restored = dpw.restored_state(None, str(out / 'whole'))
    return out, single, ranks, restored


def _assert_same_tree(a, b, schedules=True):
    ta, sa = orbax_ckpt._split(a)
    tb, sb = orbax_ckpt._split(b)
    if not schedules:
        sa.pop('schedules'), sb.pop('schedules')
    assert sa == sb
    assert set(ta) == set(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


def test_only_rank_0_writes_through_the_store(dcp_runs):
    out, _, ranks, _ = dcp_runs
    assert sorted(os.listdir(out / 'whole')) == DCP_FILES
    assert ranks[1]['writes'] == []
    dcp_writes = [p for p in ranks[0]['writes'] if p.endswith('.dcp')]
    # whole: 2 x (2 rolling saves, an epoch state, the epoch's end
    # marker); cut: 2 + 1 + 1 in epoch 1 and 1 rolling save in epoch 2;
    # resumed: 1 + 1 + 1
    assert len(dcp_writes) == 8 + 5 + 3
    assert not any(p.endswith('.tmp') for p in os.listdir(out / 'cut'))


def test_two_ranks_resume_bit_equal(dcp_runs):
    """Stopped when asking for epoch 2's second batch and resumed from
    the rolling ``.dcp`` slot on both ranks: every tensor of the state,
    the step and optimizer counts and the epoch-2 files equal the
    uninterrupted run's bit for bit. (The plateau schedule's best
    validation mean differs: the resumed process's validation loader
    starts its flips afresh.)"""
    out, _, ranks, _ = dcp_runs
    for r in ranks:
        assert r['resumed_at'] == (2, 1)
        assert r['resumed_from'].startswith('training_state_step_')
        _assert_same_tree(r['state'], r['cut_state'], schedules=False)
    _assert_same_tree(ranks[0]['state'], ranks[1]['state'])
    assert_same_epoch_files(out / 'whole', out / 'cut', 2)


def test_one_process_restores_the_two_ranks_state(dcp_runs):
    _, _, ranks, restored = dcp_runs
    _assert_same_tree(ranks[0]['state'], restored)


def test_two_ranks_restore_one_process_state(dcp_runs):
    _, single, ranks, _ = dcp_runs
    for r in ranks:
        _assert_same_tree(single, r['restored'])
