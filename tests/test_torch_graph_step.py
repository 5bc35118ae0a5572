"""The captured train step (``train/graph.py``) and what it needs, on the
CPU: the device-tensor Adam / ``MultiSteps`` against the JAX step when the
learning rate changes between steps, the captured step's bookkeeping
with the capture stubbed (the graph itself needs the card, where
``chip_smoke.py`` holds it bit for bit against the eager step), the
Trainer's step cache and in-place restores, exact-resume files, and
``patchgan_aot`` (``cli/aot.py``) against the JAX CLI's keys and an
analytic FLOP count.

nf=4, batch 2, 128 px, 3 classes, as test_torch_finetune.py. Tolerances:
losses rtol 2e-3 / atol 2e-4 at every step; each update's change of
every parameter within Adam's sign-flip bound at that update's learning
rate (99.9% of the elements within 0.05 lr + 5e-3 of the JAX change,
every one within 2.5 lr: tests/test_train_step_parity.py:114-129 at lr
1e-3); the FLOP count within 1% of the analytic one.
"""

import contextlib
import json
import types

import numpy as np
import pytest
import torch

import torch_parity
from patchgan_tpu_torch.models import Discriminator, UNet
from patchgan_tpu_torch.models.blocks import FUSED_CONV_MIN_CIN
from patchgan_tpu_torch.train import Trainer
from patchgan_tpu_torch.train import graph as graph_module
from patchgan_tpu_torch.train.graph import CapturedStep, cuda_graph_enabled
from patchgan_tpu_torch.train.schedulers import ConstantLR
from patchgan_tpu_torch.train.steps import make_optimizer, make_train_step
from patchgan_tpu_torch.utils.transfer import state_dict_from_jax

torch.set_num_threads(2)

SIZE, ACT, OUT_C, HEAD = 128, 'leakyrelu', 3, 'softmax'
# the learning rate written before each (mini-)step; an update lands at
# every k-th, at the rate written last
LRS = {1: (3e-4, 1e-4), 2: (5e-4, 3e-4, 2e-4, 1e-4)}


def _jax_params(state):
    import jax
    g, d = jax.device_get((state.g_params, state.d_params))
    return {**{f'g.{k}': v for k, v in state_dict_from_jax(g).items()},
            **{f'd.{k}': v for k, v in state_dict_from_jax(d).items()}}


def _port_params(gen, disc):
    return {**{f'g.{k}': v.clone() for k, v in gen.state_dict().items()},
            **{f'd.{k}': v.clone() for k, v in disc.state_dict().items()}}


def _assert_update_close(j0, j1, p0, p1, lr):
    """The change of every parameter in one update, port against JAX,
    within the sign-flip bound at ``lr``."""
    for key in j0:
        want = (j1[key] - j0[key]).numpy()
        got = (p1[key] - p0[key]).numpy()
        diff = np.abs(want - got)
        tight = diff <= 0.05 * lr + 5e-3 * np.abs(want)
        assert np.mean(tight) >= 0.999, f'{key}: {np.mean(~tight):.2%} loose'
        assert diff.max() <= 2.5 * lr, f'{key}: max diff {diff.max():.2e}'


def _sync(state, models, opts):
    """The port's parameters and Adam moments set to the JAX state's, so
    each compared update starts, as the first one does, from the same
    weights and moments in both packages."""
    import jax
    for model, params, opt_state, opt in zip(
            models, (state.g_params, state.d_params),
            (state.g_opt_state, state.d_opt_state), opts):
        opt_state = getattr(opt_state, 'inner_opt_state', opt_state)
        adam = jax.device_get(opt_state.inner_state[0])
        model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
        mu, nu = state_dict_from_jax(adam.mu), state_dict_from_jax(adam.nu)
        names = [n for n, _ in model.named_parameters()]
        inner = getattr(opt, 'inner', opt)
        inner.load_state_dict({'mu': [mu[n] for n in names],
                               'nu': [nu[n] for n in names],
                               'count': int(adam.count), 'lr': inner.lr})


@pytest.mark.parametrize('every_k', [1, 2], ids=['adam', 'multisteps-k2'])
def test_lr_written_between_steps_matches_jax(every_k):
    """The optimizers' learning rate written before every (mini-)step in
    both packages, the JAX side through the Trainer's
    ``_set_learning_rate``: losses at every step, and each update's
    change at the rate written last, from the same weights and moments
    (``_sync``)."""
    from patchgan_tpu.train.trainer import _set_learning_rate
    state, step = torch_parity.jax_case(SIZE, ACT, OUT_C, HEAD,
                                        every_k=every_k)
    gen, disc = torch_parity.port_models(state, ACT, OUT_C, HEAD)
    gen_opt = make_optimizer(gen.parameters(), torch_parity.LR,
                             every_k=every_k)
    disc_opt = make_optimizer(disc.parameters(), torch_parity.LR,
                              every_k=every_k)
    port_step = make_train_step(gen, disc, gen_opt, disc_opt,
                                loss_type='tversky', seg_alpha=200.0)
    lrs = LRS[every_k]
    jl, pl = [], []
    for i, (x, y) in enumerate(torch_parity.batches(SIZE, OUT_C,
                                                    len(lrs))):
        if i % every_k == 0:
            _sync(state, (gen, disc), (gen_opt, disc_opt))
            j0, p0 = _jax_params(state), _port_params(gen, disc)
        state = state._replace(
            g_opt_state=_set_learning_rate(state.g_opt_state, lrs[i]),
            d_opt_state=_set_learning_rate(state.d_opt_state, lrs[i]))
        gen_opt.lr = disc_opt.lr = lrs[i]
        state, losses = step(state, x, y)
        jl.append({k: float(v) for k, v in losses.items()})
        pl.append({k: float(v) for k, v in port_step(
            torch_parity.nchw(x), torch_parity.nchw(y)).items()})
        if (i + 1) % every_k == 0:
            _assert_update_close(j0, _jax_params(state), p0,
                                 _port_params(gen, disc), lrs[i])
    torch_parity.assert_losses_close(jl, pl)
    inner = gen_opt.inner if every_k > 1 else gen_opt
    assert inner.count == len(lrs) // every_k
    assert int(inner.count_t) == inner.count
    assert float(inner.neg_lr_t) == -np.float32(lrs[-1])


def _models(seed=0):
    init = torch.Generator().manual_seed(seed)
    gen = UNet(3, OUT_C, nf=4, use_dropout=True, activation=ACT,
               final_act=HEAD, generator=init)
    disc = Discriminator(3 + OUT_C, ndf=4, n_layers=3, generator=init)
    return gen, disc


def _trainer(tmp_path, name, every_k):
    gen, disc = _models()
    trainer = Trainer(gen, disc, str(tmp_path / name), device='cpu', seed=3)
    trainer.accumulate_steps = every_k
    trainer._make_optimizers(1e-3, 1e-3)
    return trainer


def _host_state(trainer):
    """What a step advances on the host: the Trainer's step, both
    optimizers' counts and windows, the dropout generator's state."""
    def opt(o):
        inner = getattr(o, 'inner', o)
        return inner.count, getattr(o, 'mini_step', 0)
    return (trainer.step, opt(trainer.gen_opt), opt(trainer.disc_opt),
            bytes(trainer.generator.dropout_generator.get_state().numpy()))


@pytest.mark.parametrize('every_k', [1, 2], ids=['adam', 'multisteps-k2'])
def test_captured_step_bookkeeping(tmp_path, monkeypatch, every_k):
    """The captured path with its CUDA parts stubbed on the CPU: the
    capture records the call without running it, a replay runs the
    step's device part. Each call advances the host state once, the
    capture nothing, and N calls give the eager Trainer's N updates bit
    for bit, the steps before the capture included; ``run`` (what a
    real capture records) advances nothing itself."""
    batches = [(torch_parity.nchw(x), torch_parity.nchw(y)) for x, y in
               torch_parity.batches(SIZE, OUT_C, 6, seed=1)]
    monkeypatch.setenv('PATCHGAN_CUDA_GRAPH', 'off')
    eager = _trainer(tmp_path, 'eager', every_k)
    want = []
    for x, y in batches:
        losses = eager.batch(x, y, train=True)
        want.append((_host_state(eager), losses))
    (train_step, _), = eager._step_cache[2].values()
    assert not isinstance(train_step, CapturedStep)
    assert eager.graph_counts() == (0, 0, 0)

    monkeypatch.delenv('PATCHGAN_CUDA_GRAPH')
    captured = []

    def capture(self, x, y, key):
        captured.append((key, _host_state(trainer)))

        def replay(x, y):
            losses = self._run(x, y)
            keys = list(losses)
            return keys, torch.stack([losses[k].float() for k in keys])
        return replay

    monkeypatch.setattr(graph_module, 'capturable', lambda x: True)
    monkeypatch.setattr(CapturedStep, '_capture', capture)
    monkeypatch.setattr(CapturedStep, '_side_stream',
                        lambda self, device: contextlib.nullcontext())
    trainer = _trainer(tmp_path, 'captured', every_k)
    for i, (x, y) in enumerate(batches):
        losses = trainer.batch(x, y, train=True)
        assert _host_state(trainer) == want[i][0], f'call {i + 1}'
        assert losses == want[i][1], f'call {i + 1}'
    for a, b in zip(trainer.generator.parameters(),
                    eager.generator.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(trainer.discriminator.parameters(),
                    eager.discriminator.parameters()):
        assert torch.equal(a, b)
    # one eager step and one capture per mini-step position, the capture
    # seeing the state its call started from
    assert [key[-1] for key, _ in captured] == \
        [(p, p) for p in range(every_k)]
    for n, (_, state) in enumerate(captured):
        assert state == want[every_k + n - 1][0]
    (train_step, _), = trainer._step_cache[2].values()
    assert (train_step.eager_steps, train_step.captures,
            train_step.replays) == (every_k, every_k, 6 - every_k)
    assert trainer.graph_counts() == (every_k, every_k, 6 - every_k)

    x, y = batches[0]
    state = _host_state(trainer)
    train_step._run(x, y)
    assert _host_state(trainer)[:3] == state[:3]


def test_trainer_keeps_its_steps(tmp_path, monkeypatch):
    """The steps are built once per optimizer set and loss settings, as
    the JAX Trainer's ``_get_step`` keeps its jitted steps; the captured
    step unless PATCHGAN_CUDA_GRAPH was off when the Trainer was built."""
    trainer = _trainer(tmp_path, 't', 1)
    x, y = (torch_parity.nchw(a) for a in torch_parity.batches(
        SIZE, OUT_C, 1)[0])
    steps = trainer._steps()
    assert trainer._steps() is steps
    trainer.batch(x, y, train=True)
    (train_step, _), = trainer._step_cache[2].values()
    assert isinstance(train_step, CapturedStep)
    trainer.loss_type = 'MAE'
    assert trainer._steps() is not steps
    steps = trainer._steps()
    trainer._make_optimizers(1e-3, 1e-3)
    assert trainer._step_cache is None
    # the flag is read when a Trainer is built, not at each batch
    monkeypatch.setenv('PATCHGAN_CUDA_GRAPH', 'off')
    trainer.batch(x, y, train=True)
    (train_step, _), = trainer._step_cache[2].values()
    assert isinstance(train_step, CapturedStep)
    trainer = _trainer(tmp_path, 'eager', 1)
    trainer.batch(x, y, train=True)
    (train_step, _), = trainer._step_cache[2].values()
    assert not isinstance(train_step, CapturedStep)


@pytest.mark.parametrize('flag,on', [(None, True), ('on', True),
                                     ('1', True), ('off', False),
                                     ('0', False), ('False', False)])
def test_cuda_graph_flag(monkeypatch, flag, on):
    if flag is None:
        monkeypatch.delenv('PATCHGAN_CUDA_GRAPH', raising=False)
    else:
        monkeypatch.setenv('PATCHGAN_CUDA_GRAPH', flag)
    assert cuda_graph_enabled() is on


def _tensors(trainer):
    """Every tensor a captured step reads, with its storage address."""
    out = {}
    for name, opt in (('gen', trainer.gen_opt), ('disc', trainer.disc_opt)):
        inner = getattr(opt, 'inner', opt)
        out.update({f'{name}.mu{i}': t for i, t in enumerate(inner.mu)})
        out.update({f'{name}.nu{i}': t for i, t in enumerate(inner.nu)})
        out.update({f'{name}.acc{i}': t for i, t in
                    enumerate(getattr(opt, 'acc', []))})
        out[f'{name}.count_t'], out[f'{name}.neg_lr_t'] = inner.count_t, \
            inner.neg_lr_t
    for name, model in (('g', trainer.generator),
                        ('d', trainer.discriminator)):
        out.update({f'{name}.{k}': p for k, p in model.named_parameters()})
    return out


def _pr11_state(trainer, every_k, rng):
    """An exact-resume file as the Trainer wrote it in its first release
    with exact resume: torch.save of this dict, the optimizers' counts
    and windows as ints and learning rates as floats."""
    def adam(params, count, lr):
        return {'mu': [torch.from_numpy(rng.standard_normal(p.shape)
                                        .astype(np.float32)) for p in params],
                'nu': [torch.from_numpy(rng.random(p.shape)
                                        .astype(np.float32)) for p in params],
                'count': count, 'lr': lr}

    def opt(params, count, lr):
        if every_k == 1:
            return adam(params, count, lr)
        return {'inner': adam(params, count, lr),
                'acc': [torch.from_numpy(rng.standard_normal(p.shape)
                                         .astype(np.float32))
                        for p in params],
                'mini_step': 1}

    def weights(model):
        return {k: torch.from_numpy(rng.standard_normal(v.shape)
                                    .astype(np.float32))
                for k, v in model.state_dict().items()}
    rng_state = torch.Generator().manual_seed(11)
    torch.rand(5, generator=rng_state)
    return {'generator': weights(trainer.generator),
            'discriminator': weights(trainer.discriminator),
            'gen_opt': opt(list(trainer.generator.parameters()), 7, 2.5e-4),
            'disc_opt': opt(list(trainer.discriminator.parameters()), 7,
                            4e-4),
            'dropout_rng': rng_state.get_state(), 'step': 15,
            'schedules': [['ConstantLR', {'lr': 2.5e-4}],
                          ['ConstantLR', {'lr': 4e-4}]]}


def _structure(value):
    if isinstance(value, dict):
        return {k: _structure(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_structure(v) for v in value]
    return type(value)


@pytest.mark.parametrize('every_k', [1, 2], ids=['adam', 'multisteps-k2'])
def test_exact_resume_file_restores_in_place(tmp_path, every_k):
    """A file in the exact-resume format restores into the tensors a
    captured step reads (the same storage, the device count and learning
    rate beside the host ones), and a new save has the same keys and
    types."""
    trainer = _trainer(tmp_path, 'r', every_k)
    trainer._scheds = (ConstantLR(1e-3), ConstantLR(1e-3))
    old = _pr11_state(trainer, every_k, np.random.default_rng(0))
    path = tmp_path / 'training_state_ep_001.pt'
    torch.save(old, path)
    before = {k: t.data_ptr() for k, t in _tensors(trainer).items()}
    trainer._restore_training_state(str(path))
    assert {k: t.data_ptr() for k, t in _tensors(trainer).items()} == before
    for model, key in ((trainer.generator, 'generator'),
                       (trainer.discriminator, 'discriminator')):
        for k, v in model.state_dict().items():
            assert torch.equal(v, old[key][k]), k
    for opt, key in ((trainer.gen_opt, 'gen_opt'),
                     (trainer.disc_opt, 'disc_opt')):
        saved = old[key] if every_k == 1 else old[key]['inner']
        inner = getattr(opt, 'inner', opt)
        assert all(torch.equal(a, b) for a, b in zip(inner.mu, saved['mu']))
        assert all(torch.equal(a, b) for a, b in zip(inner.nu, saved['nu']))
        assert (inner.count, int(inner.count_t)) == (7, 7)
        assert inner.lr == saved['lr']
        assert float(inner.neg_lr_t) == -np.float32(saved['lr'])
        if every_k > 1:
            assert opt.mini_step == 1
            assert all(torch.equal(a, b)
                       for a, b in zip(opt.acc, old[key]['acc']))
    assert torch.equal(trainer.generator.dropout_generator.get_state(),
                       old['dropout_rng'])
    assert trainer.step == 15
    assert _structure(trainer.training_state()) == _structure(old)


def test_epoch_files_load_in_place(tmp_path):
    """``load`` and ``load_transfer_checkpoints`` copy into the
    parameters a captured step reads."""
    trainer = _trainer(tmp_path, 'l', 1)
    trainer.save(1)
    want = {k: v.clone() for k, v in
            _port_params(trainer.generator, trainer.discriminator).items()}
    with torch.no_grad():
        for p in list(trainer.generator.parameters()) + \
                list(trainer.discriminator.parameters()):
            p.add_(1.0)
    before = {k: t.data_ptr() for k, t in _tensors(trainer).items()}
    folder = str(tmp_path / 'l')
    trainer.load(f'{folder}/generator_ep_001.npz',
                 f'{folder}/discriminator_ep_001.npz')
    got = _port_params(trainer.generator, trainer.discriminator)
    assert all(torch.equal(got[k], want[k]) for k in want)
    trainer.load_transfer_checkpoints(f'{folder}/generator_ep_001.npz',
                                      f'{folder}/discriminator_ep_001.npz')
    assert {k: t.data_ptr() for k, t in _tensors(trainer).items()} == before


# patchgan_aot

def _aot_config(tmp_path, nf):
    import yaml
    cfg = {'dataset': {'type': 'COCOStuff', 'size': SIZE,
                       'labels': list(range(1, OUT_C + 1))},
           'model_params': {'generator': {'filters': nf, 'activation': ACT,
                                          'use_dropout': True,
                                          'final_activation': HEAD},
                            'discriminator': {'filters': nf,
                                              'n_layers': 3}},
           'train_params': {'loss_type': 'tversky', 'seg_alpha': 200}}
    path = tmp_path / 'train.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _keys(record):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in record.items()}


def test_aot_keys_equal_the_jax_clis(tmp_path, monkeypatch, capsys):
    """The JAX CLI's record on a one-device CPU mesh (its detached TPU
    topology replaced by the CPU's device, so XLA compiles for the CPU)
    and the port's ``-d cpu`` record have the same keys."""
    import jax
    from jax.experimental import topologies
    from patchgan_tpu.cli.aot import patchgan_aot as jax_aot
    from patchgan_tpu_torch.cli.aot import patchgan_aot
    monkeypatch.setattr(topologies, 'get_topology_desc',
                        lambda platform, topology_name: types.SimpleNamespace(
                            devices=jax.devices('cpu')[:1]))
    monkeypatch.setattr(topologies, 'make_mesh',
                        lambda topo, shape, names: jax.sharding.Mesh(
                            np.array(topo.devices).reshape(shape), names))
    flags = ['--gen-filts', '4', '--disc-filts', '4', '--batch', '2',
             '--size', str(SIZE), '--no-s2d']
    jax_aot(['--topology', 'cpu'] + flags)
    want = _last_json(capsys)
    patchgan_aot(['-d', 'cpu', '--dtype', 'float32'] + flags)
    got = _last_json(capsys)
    assert want['compile_ok'] and got['compile_ok']
    assert _keys(got) == _keys(want)
    assert (got['batch'], got['size'], got['s2d'], got['mesh']) == \
        (2, SIZE, False, {'data': 1, 'model': 1})


def _analytic_flops(n, in_c, out_c, size, nf, ndf):
    """(2 x MACs of every conv and convT of one plain-form train step
    (paired discriminator, nothing frozen), those of its recompute): each
    forward; in the backward, the recompute of every fused level (K2's
    enc levels with Cin >= FUSED_CONV_MIN_CIN, K3's dec1-dec5), the input
    gradient where the input takes one and the weight gradient where the
    weight does."""
    def conv(cin, cout, hw):
        return 2 * n * hw * hw * cin * cout * 16

    filts = [nf, 2 * nf, 4 * nf, 8 * nf, 8 * nf, 8 * nf, 8 * nf]
    dec = filts[:-1][::-1]
    total = recompute = 0
    for i, cout in enumerate(filts):
        cin = in_c if i == 0 else filts[i - 1]
        fused = i > 0 and cin >= FUSED_CONV_MIN_CIN
        # forward, weight gradient; the image takes no gradient
        total += conv(cin, cout, size >> (i + 1)) * (
            2 if i == 0 else 4 if fused else 3)
        recompute += conv(cin, cout, size >> (i + 1)) if fused else 0
    # convT's products run over its input plane
    total += 3 * conv(filts[-1], dec[0], size >> 7)
    for i in range(1, 6):
        total += 4 * conv(dec[i - 1] + filts[6 - i], dec[i], size >> (7 - i))
        recompute += conv(dec[i - 1] + filts[6 - i], dec[i], size >> (7 - i))
    total += 3 * conv(dec[-1] + filts[0], out_c, size >> 1)
    # the discriminator: conv0 k4 s2, then s2, s2, s1, s1 (out 1 channel)
    tail = [conv(ndf, 2 * ndf, size // 4), conv(2 * ndf, 4 * ndf, size // 8),
            conv(4 * ndf, 8 * ndf, size // 8 - 1),
            conv(8 * ndf, 1, size // 8 - 2)]
    # in G's loss, on (x, gen_img), its weights constant: forward and
    # input gradients down to conv0's input
    total += 2 * (conv(in_c + out_c, ndf, size // 2) + sum(tail))
    # its own step, paired: conv0's image part once and two mask parts,
    # forward and weight gradient; the tail for each pair, forward and
    # both gradients
    total += 2 * (conv(in_c, ndf, size // 2) + 2 * conv(out_c, ndf, size // 2))
    total += 2 * 3 * sum(tail)
    return total, recompute


def test_aot_flops_match_the_analytic_count(tmp_path, capsys):
    """nf=8, so enc1 (Cin 8) runs a plain conv and enc2-enc6 the fused
    one; batch 2. The recompute in the count is exactly the fused
    levels' forward, and the human line gives the count without it."""
    from patchgan_tpu_torch.cli import aot
    path = _aot_config(tmp_path, 8)
    result = aot.patchgan_aot(['-c', path, '-d', 'cpu', '--dtype',
                               'float32', '--batch', '2', '--no-s2d'])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(result))
    want, want_recompute = _analytic_flops(2, 3, OUT_C, SIZE, 8, 8)
    got = result['cost']['flops_per_device']
    assert abs(got - want) <= 0.01 * want, (got, want)
    assert result['cost']['optimal_seconds'] == pytest.approx(got / 67e12)
    assert result['memory_per_device']['fits'] is None
    in_c, out_c, size, gen_cfg, disc_cfg, loss_kwargs = aot._config(
        types.SimpleNamespace(config_file=path, gen_filts=None,
                              disc_filts=None, size=None))
    total, recompute = aot.step_flops(in_c, out_c, size, gen_cfg, disc_cfg,
                                      False, loss_kwargs)
    assert (2 * total, 2 * recompute) == (got, want_recompute)
    line, = [l for l in out.splitlines() if 'of it the recompute' in l]
    assert f'levels {want_recompute / 1e9:.1f} GFLOP; without it ' \
        f'{(got - want_recompute) / 1e9:.1f} GFLOP' in line, line


@pytest.mark.parametrize('flag', ['--dp', '--tp'])
def test_aot_parallel_modes_raise(flag):
    """--tp above 1 runs under torchrun only: outside it, it raises
    saying how to launch it; --dp runs, but a global batch that does not
    divide across its ranks raises, naming both."""
    from patchgan_tpu_torch.cli.aot import patchgan_aot
    if flag == '--tp':
        with pytest.raises(ValueError, match='under torchrun'):
            patchgan_aot([flag, '2', '-d', 'cpu'])
    else:
        with pytest.raises(ValueError, match='--batch 16 .* --dp 3'):
            patchgan_aot([flag, '3', '-d', 'cpu'])


def test_aot_on_cuda_needs_a_card():
    from patchgan_tpu_torch.cli.aot import patchgan_aot
    if torch.cuda.is_available():
        pytest.skip('a card is present; chip_smoke.py runs -d cuda')
    with pytest.raises(RuntimeError, match='CUDA'):
        patchgan_aot(['-d', 'cuda', '--gen-filts', '4', '--disc-filts',
                      '4', '--size', str(SIZE)])
