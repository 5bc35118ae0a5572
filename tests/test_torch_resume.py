"""Exact resume in the port's Trainer, as the JAX package's tests hold
its own (``tests/test_trainer.py``): with ``save_optimizer_state`` a
resumed run equals an uninterrupted one bit for bit (fp32, CPU); with
``save_every_steps`` a run killed mid-epoch (inside an accumulation
window too, and again after resuming) continues bit for bit; the
rolling slots never rewrite the file the metadata names; neither
package reads the other's exact-resume files; the neptune hooks and
``profile_dir``."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from patchgan_tpu.models import Discriminator as JaxDisc
from patchgan_tpu.models import UNet as JaxUNet
from patchgan_tpu.parallel.mesh import default_mesh
from patchgan_tpu.train import Trainer as JaxTrainer
from patchgan_tpu_torch.cli.train import patchgan_train
from patchgan_tpu_torch.data import COCOStuffDataset, DataLoader
from patchgan_tpu_torch.models import Discriminator, UNet
from patchgan_tpu_torch.train import Trainer
from patchgan_tpu_torch.train.trainer import STEP_META
from patchgan_tpu_torch.utils.profiling import StepTimer, maybe_trace

torch.set_num_threads(2)

NF, SIZE = 4, 128


def make_trainer(folder, seed=3, accumulate=1):
    gen = UNet(3, 1, nf=NF, activation='tanh', final_act='sigmoid',
               use_dropout=True, generator=torch.Generator().manual_seed(1))
    disc = Discriminator(4, ndf=NF, n_layers=2,
                         generator=torch.Generator().manual_seed(2))
    trainer = Trainer(gen, disc, str(folder), seed=seed)
    trainer.accumulate_steps = accumulate
    return trainer


def synth_batches(seed, n_batches=4, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = rng.uniform(size=(n, 3, SIZE, SIZE)).astype(np.float32)
        y = (rng.uniform(size=(n, 1, SIZE, SIZE)) > 0.5).astype(np.float32)
        out.append((torch.from_numpy(x), torch.from_numpy(y)))
    return out


class Preemptible:
    """Serves ``batches`` each epoch and raises at the ``fail_at``-th
    batch served, as a kill would stop the run there."""

    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at, self.served = batches, fail_at, 0

    def __iter__(self):
        for b in self.batches:
            self.served += 1
            if self.served == self.fail_at:
                raise KeyboardInterrupt('preempted')
            yield b


class PreemptIter:
    """A proxy over a DataLoader that raises at the ``fail_at``-th batch
    served."""

    def __init__(self, inner, fail_at):
        self.inner, self.fail_at, self.served = inner, fail_at, 0

    def __iter__(self):
        for b in self.inner:
            self.served += 1
            if self.served == self.fail_at:
                raise KeyboardInterrupt('preempted')
            yield b

    def __len__(self):
        return len(self.inner)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def assert_same_state(a, b):
    """Both models' weights, both optimizers' states and the dropout
    generator's state equal bit for bit."""
    sa, sb = a.training_state(), b.training_state()
    assert sa['step'] == sb['step']
    assert torch.equal(sa['dropout_rng'], sb['dropout_rng'])

    def leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k])
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from leaves(v)
        else:
            yield tree
    la, lb = list(leaves(sa)), list(leaves(sb))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def assert_same_epoch_files(folder_a, folder_b, epoch):
    for prefix in ('generator', 'discriminator'):
        name = f'{prefix}_ep_{epoch:03d}.npz'
        with np.load(os.path.join(folder_a, name)) as a, \
                np.load(os.path.join(folder_b, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize('accumulate,mu_dtype', [
    (1, None), (2, None), (1, torch.bfloat16)],
    ids=['adam', 'accumulate', 'mu-bf16'])
def test_optimizer_state_resume_equals_uninterrupted(tmp_path, accumulate,
                                                     mu_dtype):
    """save_optimizer_state: epoch 1, a new Trainer (another seed) that
    resumes, epoch 2, against two epochs in one run: every tensor of the
    state and the epoch-2 files equal. accumulate 2 over 3 batches leaves
    a window open across the epoch boundary."""
    data = synth_batches(70, n_batches=3)
    full = make_trainer(tmp_path / 'a', accumulate=accumulate)
    full.adam_mu_dtype = mu_dtype
    full.save_optimizer_state = True
    full.train(data, data[:1], epochs=2, save_freq=1)

    first = make_trainer(tmp_path / 'b', accumulate=accumulate)
    first.adam_mu_dtype = mu_dtype
    first.save_optimizer_state = True
    first.train(data, data[:1], epochs=1, save_freq=1)
    assert os.path.exists(tmp_path / 'b' / 'training_state_ep_001.pt')
    cont = make_trainer(tmp_path / 'b', seed=999, accumulate=accumulate)
    cont.adam_mu_dtype = mu_dtype
    cont.save_optimizer_state = True
    cont.load_last_checkpoint()
    assert cont.start == 2 and cont._pending_training_state.endswith(
        'training_state_ep_001.pt')
    cont.train(data, data[:1], epochs=2, save_freq=1)
    assert cont.step == full.step == 6
    assert_same_state(full, cont)
    assert_same_epoch_files(tmp_path / 'a', tmp_path / 'b', 2)


def test_without_optimizer_state_adam_restarts(tmp_path):
    """The reference's resume (no save_optimizer_state): Adam starts
    afresh, so the continuation differs from the uninterrupted run."""
    data = synth_batches(71, n_batches=2)
    full = make_trainer(tmp_path / 'a')
    full.train(data, [], epochs=2, save_freq=1)
    first = make_trainer(tmp_path / 'b')
    first.train(data, [], epochs=1, save_freq=1)
    cont = make_trainer(tmp_path / 'b')
    cont.load_last_checkpoint()
    assert cont._pending_training_state is None
    cont.train(data, [], epochs=2, save_freq=1)
    want = full.generator.state_dict()
    assert any(not torch.equal(v, want[k])
               for k, v in cont.generator.state_dict().items())


def test_step_checkpoint_writes_rolling_state(tmp_path):
    trainer = make_trainer(tmp_path)
    trainer.save_every_steps = 2
    data = synth_batches(72)
    trainer.train(data, data[:1], epochs=1, save_freq=10)
    slots = sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / 'training_state_step_*.pt')))
    assert slots == ['training_state_step_a.pt', 'training_state_step_b.pt']
    # the end-of-epoch marker supersedes the mid-epoch entries: "epoch
    # 2, nothing done"
    with open(tmp_path / STEP_META) as f:
        meta = json.load(f)
    assert meta['epoch'] == 2 and meta['batches_done'] == 0
    assert not os.path.exists(tmp_path / 'step_state.json')


@pytest.mark.parametrize('accumulate,fail_at,done', [
    (1, 4, 3), (2, 4, 3), (2, 6, 1)],
    ids=['mid-epoch', 'mid-window', 'second-epoch'])
def test_preemption_resume_matches_uninterrupted(tmp_path, accumulate,
                                                 fail_at, done):
    """Killed at the fail_at-th batch with a rolling save after every
    batch: a new Trainer resumes from the rolling state and finishes bit
    for bit as the uninterrupted run. With accumulate 2, a cut after 3
    batches leaves the window open (the mean gradient of batch 3 and the
    mini-step count are restored); fail_at 6 cuts epoch 2 after 1."""
    batches = synth_batches(73)
    ref = make_trainer(tmp_path / 'a', accumulate=accumulate)
    ref.train(list(batches), batches[:1], epochs=2, save_freq=1)

    pre = make_trainer(tmp_path / 'b', accumulate=accumulate)
    pre.save_every_steps = 1
    with pytest.raises(KeyboardInterrupt):
        pre.train(Preemptible(batches, fail_at=fail_at), batches[:1],
                  epochs=2, save_freq=1)

    cont = make_trainer(tmp_path / 'b', seed=999, accumulate=accumulate)
    cont.load_last_checkpoint()
    assert cont.start == (1 if fail_at <= 4 else 2)
    assert cont._resume_skip_batches == done
    cont.train(list(batches), batches[:1], epochs=2, save_freq=1)
    assert_same_state(ref, cont)
    assert_same_epoch_files(tmp_path / 'a', tmp_path / 'b', 2)


@pytest.mark.parametrize('schedule', [
    dict(lr_decay=0.5, decay_freq=2), dict(reduce_on_plateau=True)],
    ids=['decay', 'plateau'])
@pytest.mark.parametrize('source', ['rolling', 'epoch-file'])
def test_resume_continues_the_lr_schedule(tmp_path, schedule, source):
    """The exact-resume state carries the schedules: a resume at epoch 2
    of a decay every 2 epochs keeps epoch 2's LR (the reference's
    fast-forward would take lr * 0.5 ** 0.5) and decays after it, and the
    plateau counters go on; the state equals the uninterrupted run's after
    3 epochs."""
    batches = synth_batches(84, n_batches=2)
    ref = make_trainer(tmp_path / 'a')
    ref.train(list(batches), batches[:1], epochs=3, save_freq=1, **schedule)

    pre = make_trainer(tmp_path / 'b')
    if source == 'rolling':
        pre.save_every_steps = 1
        with pytest.raises(KeyboardInterrupt):
            pre.train(Preemptible(batches, fail_at=4), batches[:1],
                      epochs=3, save_freq=1, **schedule)
    else:
        pre.save_optimizer_state = True
        pre.train(list(batches), batches[:1], epochs=1, save_freq=1,
                  **schedule)
    cont = make_trainer(tmp_path / 'b', seed=999)
    cont.load_last_checkpoint()
    assert cont.start == 2
    cont.train(list(batches), batches[:1], epochs=3, save_freq=1, **schedule)
    assert [s.lr for s in cont._scheds] == [s.lr for s in ref._scheds]
    assert_same_state(ref, cont)


def _raw_dataset(tmp_path, n=8):
    """A COCO folder of n 128-px pairs, flips on."""
    imgdir, maskdir = tmp_path / 'img', tmp_path / 'mask'
    imgdir.mkdir()
    maskdir.mkdir()
    rng = np.random.default_rng(74)
    for i in range(n):
        img = (rng.uniform(size=(SIZE, SIZE, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(imgdir / f'{i:04d}.jpg')
        mask = rng.integers(0, 2, (SIZE, SIZE)).astype(np.uint8)
        Image.fromarray(mask, mode='L').save(maskdir / f'{i:04d}.png')
    return COCOStuffDataset(str(imgdir), str(maskdir), labels=[1],
                            size=SIZE, augmentation='randomcrop+flip')


def test_chained_preemption_resume_matches_uninterrupted(tmp_path):
    """A resume of a resumed run, with real DataLoaders (shuffle and
    flips on): the metadata records the loader iteration, so the
    replayed order and the skip land on the right batches, and the
    state equals the uninterrupted run's bit for bit."""
    ds = _raw_dataset(tmp_path)

    def loader():
        return DataLoader(ds, batch_size=2, num_workers=1, seed=5)

    ref = make_trainer(tmp_path / 'ref', accumulate=2)
    ref.train(loader(), [], epochs=3, save_freq=10)

    # run 1: epoch 1 only, with step checkpointing
    r1 = make_trainer(tmp_path / 'x', accumulate=2)
    r1.save_every_steps = 1
    r1.train(loader(), [], epochs=1, save_freq=10)

    # run 2: resumes at epoch 2 with a fresh loader, cut at its 4th batch
    r2 = make_trainer(tmp_path / 'x', seed=77, accumulate=2)
    r2.save_every_steps = 1
    r2.load_last_checkpoint()
    assert r2.start == 2 and r2._resume_skip_batches == 0
    with pytest.raises(KeyboardInterrupt):
        r2.train(PreemptIter(loader(), fail_at=4), [], epochs=3,
                 save_freq=10)

    # run 3: resumes mid-epoch-2 of a resumed run, mid-window
    r3 = make_trainer(tmp_path / 'x', seed=123, accumulate=2)
    r3.load_last_checkpoint()
    assert r3.start == 2 and r3._resume_skip_batches == 3
    r3.train(loader(), [], epochs=3, save_freq=10)
    assert_same_state(ref, r3)


def test_step_checkpoint_slots_never_rewrite_live_slot(tmp_path):
    """Every rolling save writes the slot the current metadata does not
    name, the first save after a resume included."""
    def live_slot():
        with open(tmp_path / STEP_META) as f:
            return json.load(f)['state']

    pre = make_trainer(tmp_path)
    pre.save_every_steps = 1
    with pytest.raises(KeyboardInterrupt):
        pre.train(Preemptible(synth_batches(75), fail_at=3), [], epochs=1,
                  save_freq=10)
    first = live_slot()
    cont = make_trainer(tmp_path, seed=3)
    cont.save_every_steps = 1
    cont.load_last_checkpoint()
    cont._save_step_state(1, 3)
    second = live_slot()
    assert first != second
    for name in (first, second):
        assert os.path.exists(tmp_path / name)


def test_crash_between_state_and_metadata_leaves_a_consistent_pair(
        tmp_path, monkeypatch):
    """A kill after the third save's state file but before its metadata:
    the metadata still names the second save's slot, intact, and the
    resume from it (2 batches done) finishes as the uninterrupted run."""
    batches = synth_batches(76)
    ref = make_trainer(tmp_path / 'a')
    ref.train(list(batches), [], epochs=1, save_freq=1)

    pre = make_trainer(tmp_path / 'b')
    pre.save_every_steps = 1
    real_dump, calls = json.dump, []

    def dump(obj, f):
        calls.append(obj)
        if len(calls) == 3:
            raise KeyboardInterrupt('killed before the metadata')
        real_dump(obj, f)
    monkeypatch.setattr(json, 'dump', dump)
    with pytest.raises(KeyboardInterrupt):
        pre.train(list(batches), [], epochs=1, save_freq=1)
    monkeypatch.setattr(json, 'dump', real_dump)
    with open(tmp_path / 'b' / STEP_META) as f:
        meta = json.load(f)
    assert meta['batches_done'] == 2 and meta['state'] == calls[1]['state']
    assert calls[2]['state'] != meta['state']   # the slot being written

    cont = make_trainer(tmp_path / 'b', seed=5)
    cont.load_last_checkpoint()
    assert cont._resume_skip_batches == 2
    cont.train(list(batches), [], epochs=1, save_freq=1)
    assert_same_state(ref, cont)


def test_torn_metadata_is_ignored(tmp_path, capsys):
    """Metadata naming a missing state file, or unreadable metadata,
    gives a plain resume, not a crash."""
    trainer = make_trainer(tmp_path)
    with open(tmp_path / STEP_META, 'w') as f:
        json.dump({'epoch': 5, 'batches_done': 3,
                   'state': 'training_state_step_a.pt'}, f)
    trainer.load_last_checkpoint()
    assert trainer.start == 1 and trainer._resume_skip_batches == 0
    with open(tmp_path / STEP_META, 'w') as f:
        f.write('{not json')
    t2 = make_trainer(tmp_path, seed=2)
    t2.load_last_checkpoint()
    assert t2.start == 1
    assert 'Ignoring unreadable step checkpoint' in capsys.readouterr().out


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


def test_jax_resumes_a_port_folder_with_rolling_files(tmp_path, jax_env):
    """A port folder with epoch files, training_state_ep_*.pt and the
    rolling slots and metadata: the JAX Trainer resumes it from the npz
    files, reading none of the port's exact-resume files."""
    batches = synth_batches(77, n_batches=2)
    pt = make_trainer(tmp_path)
    pt.save_optimizer_state = True
    pt.save_every_steps = 1
    pt.train(batches, [], epochs=1, save_freq=1)
    assert os.path.exists(tmp_path / STEP_META)
    jt = _jax_trainer(tmp_path)
    jt.load_last_checkpoint()
    assert jt.start == 2 and jt._pending_training_state is None
    assert jt._resume_skip_batches == 0
    jax_batches = [(np.transpose(x.numpy(), (0, 2, 3, 1)),
                    np.transpose(y.numpy(), (0, 2, 3, 1)))
                   for x, y in batches]
    g_hist, _ = jt.train(jax_batches, [], epochs=2, save_freq=1)
    assert np.isfinite(g_hist).all()
    assert os.path.exists(tmp_path / 'generator_ep_002.npz')


def test_port_ignores_jax_exact_resume_files(tmp_path, jax_env, capsys):
    """A JAX folder with training_state_ep_001.msgpack and a rolling
    step_state.json: the port resumes from the epoch npz files at epoch 2
    with fresh Adam moments and notes the JAX files."""
    rng = np.random.default_rng(78)
    x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    y = (rng.uniform(size=(2, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
    jt = _jax_trainer(tmp_path)
    jt.save_optimizer_state = True
    jt.save_every_steps = 1
    jt.train([(x, y)], [], epochs=1, save_freq=1)
    assert os.path.exists(tmp_path / 'training_state_ep_001.msgpack')
    assert os.path.exists(tmp_path / 'step_state.json')
    capsys.readouterr()
    pt = make_trainer(tmp_path)
    pt.load_last_checkpoint()
    out = capsys.readouterr().out
    assert pt.start == 2 and pt._pending_training_state is None
    assert "training_state_ep_001.msgpack is the JAX package's" in out
    assert "step_state.json is the JAX package's" in out
    g_hist, _ = pt.train(synth_batches(79, 1), [], epochs=2, save_freq=1)
    assert np.isfinite(g_hist).all()


class FakeNeptune:
    """A stand-in for a neptune run: item writes for parameters, lists
    with .append for metrics."""

    def __init__(self):
        self.store = {}

    def __setitem__(self, key, value):
        self.store[key] = value

    def __getitem__(self, key):
        return self.store.setdefault(key, [])


@pytest.mark.parametrize('schedule', ['constant', 'decay', 'plateau'])
def test_neptune_hooks(tmp_path, schedule):
    trainer = make_trainer(tmp_path)
    trainer.neptune_config = FakeNeptune()
    data = synth_batches(80, n_batches=1)
    kwargs = {'decay': dict(lr_decay=0.5, decay_freq=1),
              'plateau': dict(reduce_on_plateau=True),
              'constant': {}}[schedule]
    trainer.train(data, data, epochs=2, save_freq=10, **kwargs)
    store = trainer.neptune_config.store
    assert store['model/parameters/start'] == 1
    assert store['model/parameters/n_epochs'] == 2
    assert store['model/parameters/gen_learning_rate'] == 1e-3
    assert len(store['train/gen_loss']) == len(store['eval/disc_loss']) == 2
    assert all(np.isfinite(store['train/disc_loss']))
    assert store.get('model/parameters/scheduler') == {
        'constant': None, 'decay': 'ExponentialLR',
        'plateau': 'ReduceLROnPlateau'}[schedule]
    if schedule == 'decay':
        assert store['model/parameters/lr_decay'] == 0.5


def test_empty_validation_with_neptune(tmp_path):
    trainer = make_trainer(tmp_path)
    trainer.neptune_config = FakeNeptune()
    g_hist, _ = trainer.train(synth_batches(81, 1), [], epochs=1,
                              save_freq=10)
    assert len(g_hist) == 1 and np.isfinite(g_hist[0])
    assert len(trainer.neptune_config['train/gen_loss']) == 1
    assert trainer.neptune_config.store.get('eval/gen_loss', []) == []


def test_profile_dir_traces_the_first_epoch(tmp_path):
    trainer = make_trainer(tmp_path / 'ck')
    trainer.profile_dir = str(tmp_path / 'trace')
    trainer.train(synth_batches(82, 1), [], epochs=2, save_freq=10)
    traces = glob.glob(str(tmp_path / 'trace' / 'trace_*.json'))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)['traceEvents']
    names = {e.get('name', '') for e in events}
    assert any('convolution' in n for n in names)


def test_maybe_trace_off_and_step_timer(tmp_path):
    with maybe_trace(str(tmp_path / 'a'), enabled=False):
        torch.ones(3).sum()
    with maybe_trace(None):
        pass
    assert not os.path.exists(tmp_path / 'a')
    timer = StepTimer()
    timer.tick(3)
    assert timer.steps == 3 and timer.rate(per=2) > 0


def test_unported_checkpoint_format_names_its_item(tmp_path):
    trainer = make_trainer(tmp_path)
    trainer.checkpoint_format = 'orbax'
    with pytest.raises(NotImplementedError, match='ROADMAP.*item 12'):
        trainer.train(synth_batches(83, 1), [], epochs=1)


def _cli_inputs(tmp_path):
    """_raw_dataset's 8 pairs as a folder and as 2 tar shards: (images,
    masks, shard glob)."""
    import tarfile
    ds = _raw_dataset(tmp_path)
    shards = tmp_path / 'shards'
    shards.mkdir()
    for si in range(2):
        with tarfile.open(shards / f's-{si}.tar', 'w') as tf:
            for i in range(4 * si, 4 * si + 4):
                tf.add(ds.images[i], arcname=os.path.basename(ds.images[i]))
                tf.add(ds.masks[i], arcname=os.path.basename(ds.masks[i]))
    return str(tmp_path / 'img'), str(tmp_path / 'mask'), \
        str(shards / 's-*.tar')


def _cli_config(path, images, masks, ckpt, dataset_type='COCOStuff',
                **train_params):
    import yaml
    cfg = {'dataset': {'type': dataset_type, 'size': SIZE, 'labels': [1],
                       'augmentation': 'randomcrop+flip',
                       'train_data': {'images': images, 'masks': masks},
                       'validation_data': {'images': images,
                                           'masks': masks}},
           'model_params': {'generator': {'filters': NF,
                                          'use_dropout': True},
                            'discriminator': {'filters': NF,
                                              'n_layers': 2}},
           'checkpoint_path': ckpt,
           'train_params': dict(loss_type='tversky', seg_alpha=200,
                                gen_learning_rate=1e-3,
                                disc_learning_rate=1e-3, save_freq=1,
                                **train_params)}
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_cli_shards_equal_the_folder(tmp_path, monkeypatch):
    """patchgan_train on the tar shards and on the folder, flips on and
    both decoding with PIL: bit-equal epoch files; the shard run with
    process workers and the folder run with the RAM cache."""
    monkeypatch.setenv('PATCHGAN_NATIVE_IO', 'off')
    images, masks, shards = _cli_inputs(tmp_path)
    folder_cfg = _cli_config(tmp_path / 'f.yaml', images, masks,
                             str(tmp_path / 'ck_f'))
    shard_cfg = _cli_config(tmp_path / 's.yaml', shards, None,
                            str(tmp_path / 'ck_s'), dataset_type='TarShards')
    with open(folder_cfg) as f:
        text = f.read().replace('type: COCOStuff', 'type: COCOStuff\n  '
                                'cache: true')
    with open(folder_cfg, 'w') as f:
        f.write(text)
    common = ['-n', '1', '-b', '2', '-d', 'cpu', '--dtype', 'float32',
              '--no-summary', '--dataloader_workers', '2']
    patchgan_train(['-c', folder_cfg] + common)
    patchgan_train(['-c', shard_cfg, '--dataloader_worker_type', 'process']
                   + common)
    assert_same_epoch_files(tmp_path / 'ck_f', tmp_path / 'ck_s', 1)


def test_cli_rolling_resume_and_profile(tmp_path, capsys):
    """patchgan_train with save_every_steps and accumulate_steps, cut in
    epoch 2 mid-window, resumed by the CLI with load_last_checkpoint:
    epoch files bit-equal to an uninterrupted run; --profile_dir traces
    epoch 1 only."""
    import yaml
    images, masks, _ = _cli_inputs(tmp_path)
    ref_cfg = _cli_config(tmp_path / 'r.yaml', images, masks,
                          str(tmp_path / 'ck_r'), accumulate_steps=2)
    common = ['-n', '2', '-b', '2', '-d', 'cpu', '--dtype', 'float32',
              '--no-summary', '--dataloader_workers', '1']
    patchgan_train(['-c', ref_cfg, '--profile_dir', str(tmp_path / 'tr')]
                   + common)
    assert len(glob.glob(str(tmp_path / 'tr' / 'trace_*.json'))) == 1

    cut_cfg = _cli_config(tmp_path / 'c.yaml', images, masks,
                          str(tmp_path / 'ck_c'), accumulate_steps=2,
                          save_every_steps=1)
    real = Trainer._save_step_state

    def cut(self, epoch, batches_done, loader_epoch=None):
        real(self, epoch, batches_done, loader_epoch)
        if (epoch, batches_done) == (2, 3):
            raise KeyboardInterrupt('preempted')
    Trainer._save_step_state = cut
    try:
        with pytest.raises(KeyboardInterrupt):
            patchgan_train(['-c', cut_cfg] + common)
    finally:
        Trainer._save_step_state = real
    with open(cut_cfg) as f:
        cfg = yaml.safe_load(f)
    cfg['load_last_checkpoint'] = True
    with open(cut_cfg, 'w') as f:
        yaml.safe_dump(cfg, f)
    capsys.readouterr()
    patchgan_train(['-c', cut_cfg] + common)
    out = capsys.readouterr().out
    assert 'Found mid-epoch checkpoint: epoch 2, 3 batches done' in out
    assert 'Epoch 1 ' not in out
    assert_same_epoch_files(tmp_path / 'ck_r', tmp_path / 'ck_c', 2)
