"""Fine-tuning on the port against the JAX package: the frozen step
(``freeze_patterns``, JAX ``freeze_stop_gradients`` + the optimizer's
``set_to_zero`` partition) and gradient accumulation (``every_k``,
``optax.MultiSteps``).

nf=4, batch 2, 128 px, leakyrelu, 3 classes, softmax head, dropout off,
through ``torch_parity``'s JAX cases. Tolerances as in
test_torch_step.py: losses rtol 2e-3 / atol 2e-4 at every step,
parameters after the first update within Adam's sign-flip bound; frozen
parameters bit-equal to their initial values in both packages. k
accumulated half-batches against one step on the whole batch: the
tolerance of tests/test_trainer.py:640-647.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import torch_parity
from patchgan_tpu_torch.train import steps as port_steps
from patchgan_tpu_torch.train.steps import (MultiSteps, is_frozen,
                                            make_optimizer, make_train_step,
                                            trainable_params)
from patchgan_tpu_torch.utils.transfer import (state_dict_from_jax,
                                               unet_jax_path, unet_key_map)

torch.set_num_threads(2)

# the modules, which the package's functions of the same name shadow
k2_module = importlib.import_module(
    'patchgan_tpu_torch.ops.kernels.conv_norm_act')
k3_module = importlib.import_module(
    'patchgan_tpu_torch.ops.kernels.convt_norm_act')

SIZE, ACT, OUT_C, HEAD = 128, 'leakyrelu', 3, 'softmax'
FREEZES = {'enc': ('enc',), 'enc0-dec6': ('enc0', 'dec6')}
# at 128 px enc6's plane is 1x1: its normalised output is exactly 0, so
# enc6 and dec0 take a zero gradient and never move, frozen or not
STILL = ('encoder.6.model.DownConv6.weight', 'decoder.0.model.UpConv0.weight')


def _state_dicts(state):
    g, d = jax.device_get((state.g_params, state.d_params))
    return state_dict_from_jax(g), state_dict_from_jax(d)


def _run(steps, s2d=False, freeze=(), every_k=1):
    """``steps`` steps in both packages. Returns (JAX losses, port
    losses, JAX and port state_dicts after the first update, JAX and port
    generator state_dicts after the last step, initial generator
    state_dict, port generator)."""
    state, step = torch_parity.jax_case(SIZE, ACT, OUT_C, HEAD, s2d, freeze,
                                        every_k)
    init = _state_dicts(state)[0]
    gen, disc = torch_parity.port_models(state, ACT, OUT_C, HEAD)
    port_step = make_train_step(
        gen, disc,
        make_optimizer(trainable_params(gen, freeze), torch_parity.LR,
                       every_k=every_k),
        make_optimizer(disc.parameters(), torch_parity.LR, every_k=every_k),
        loss_type='tversky', seg_alpha=200.0, s2d=s2d)
    jl, pl, first = [], [], None
    for i, (x, y) in enumerate(torch_parity.batches(SIZE, OUT_C, steps)):
        state, losses = step(state, x, y)
        jl.append({k: float(v) for k, v in losses.items()})
        pl.append({k: float(v) for k, v in port_step(
            torch_parity.nchw(x), torch_parity.nchw(y)).items()})
        if i == every_k - 1:
            first = (_state_dicts(state),
                     ({k: v.clone() for k, v in gen.state_dict().items()},
                      {k: v.clone() for k, v in disc.state_dict().items()}))
    return jl, pl, first, (_state_dicts(state)[0], gen.state_dict()), \
        init, gen


def _assert_first_update_close(first):
    (jg, jd), (tg, td) = first
    torch_parity.assert_params_close(jg, tg)
    torch_parity.assert_params_close(jd, td)


def test_jax_paths_of_the_generator_keys():
    keys = unet_key_map()
    assert [unet_jax_path(k) for k in keys] == \
        [f'enc{i}/kernel' for i in range(7)] + \
        [f'dec{i}/kernel' for i in range(7)]
    assert [k for k in keys if is_frozen(k, ('enc0', 'dec6'))] == [
        'encoder.0.model.DownConv0.weight', 'decoder.6.model.UpConv6.weight']
    assert sum(is_frozen(k, ('enc',)) for k in keys) == 7


@pytest.mark.parametrize('s2d', [False, True], ids=['plain', 's2d'])
@pytest.mark.parametrize('name', sorted(FREEZES))
def test_frozen_step_matches_jax(name, s2d):
    """Two frozen steps in both packages: losses of each step, every
    parameter after the first, frozen parameters bit-equal to their
    initial values after both, in both packages."""
    freeze = FREEZES[name]
    jl, pl, first, (jg_last, tg_last), init, gen = _run(
        2, s2d=s2d, freeze=freeze)
    torch_parity.assert_losses_close(jl, pl)
    _assert_first_update_close(first)
    frozen = [k for k in init if is_frozen(k, freeze)]
    assert frozen
    for k in init:
        if k in frozen:
            torch.testing.assert_close(jg_last[k], init[k], rtol=0, atol=0)
            torch.testing.assert_close(tg_last[k], init[k], rtol=0, atol=0)
        elif k not in STILL:
            assert not torch.equal(tg_last[k], init[k]), k
    assert all(p.requires_grad for p in gen.parameters())


def test_accumulation_matches_jax():
    """every_k=2 in both packages over four steps: no parameter moves at
    the first step, the update lands at the second."""
    jl, pl, first, _, init, _ = _run(4, every_k=2)
    torch_parity.assert_losses_close(jl, pl)
    _assert_first_update_close(first)


def test_frozen_accumulation_matches_jax():
    jl, pl, first, (jg_last, tg_last), init, _ = _run(
        4, freeze=('enc',), every_k=2)
    torch_parity.assert_losses_close(jl, pl)
    _assert_first_update_close(first)
    for k in init:
        if k.startswith('encoder'):
            torch.testing.assert_close(jg_last[k], init[k], rtol=0, atol=0)
            torch.testing.assert_close(tg_last[k], init[k], rtol=0, atol=0)


def test_pattern_matching_nothing_freezes_nothing():
    """A pattern no path starts with: both packages give exactly what
    their unfrozen step gives."""
    free = _run(2)
    none = _run(2, freeze=('encoder',))
    init = none[4]
    assert none[1] == free[1]
    (jax_none, port_none), (jax_free, port_free) = none[3], free[3]
    for k in init:
        assert k in STILL or not torch.equal(jax_none[k], init[k]), k
        torch.testing.assert_close(jax_none[k], jax_free[k], rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(port_none[k], port_free[k], rtol=0,
                                   atol=0)


def test_multisteps_holds_the_update_until_the_kth_call():
    """The accumulator keeps the running mean; Adam's count and the
    parameters move only on every k-th call, and lr reaches the inner
    Adam."""
    p = [torch.zeros(3)]
    opt = make_optimizer(p, 1e-3, every_k=3)
    assert isinstance(opt, MultiSteps) and opt.inner.params[0] is p[0]
    grads = (1.0, 2.0, 6.0)
    for i, g in enumerate(grads):
        opt.step([torch.full((3,), g)])
        if i < 2:
            assert opt.inner.count == 0 and torch.equal(p[0],
                                                        torch.zeros(3))
            assert torch.equal(opt.acc[0], torch.full(
                (3,), float(np.mean(grads[:i + 1]))))
    assert opt.inner.count == 1 and opt.mini_step == 0
    assert torch.equal(opt.acc[0], torch.zeros(3))
    np.testing.assert_allclose(p[0].numpy(), -1e-3, rtol=1e-5)
    opt.lr = 5e-4
    assert opt.inner.lr == 5e-4


def test_accumulated_half_batches_match_one_batch():
    """The port's k=2 over two half-batches against its own step on the
    whole batch: every loss term is a per-sample mean and instance norm
    is per sample, so the mean gradient equals the big batch's up to the
    reassociated reduction and the tversky focal power; an element whose
    gradient is near zero may flip its Adam sign (up to 2 lr), rarely."""
    state, _ = torch_parity.jax_case(SIZE, ACT, OUT_C, HEAD)
    (x0, y0), (x1, y1) = [(torch_parity.nchw(x), torch_parity.nchw(y))
                          for x, y in torch_parity.batches(SIZE, OUT_C, 2)]
    results = []
    for every_k, batches in ((2, [(x0, y0), (x1, y1)]),
                             (1, [(torch.cat([x0, x1]),
                                   torch.cat([y0, y1]))])):
        gen, disc = torch_parity.port_models(state, ACT, OUT_C, HEAD)
        step = make_train_step(
            gen, disc,
            make_optimizer(gen.parameters(), torch_parity.LR,
                           every_k=every_k),
            make_optimizer(disc.parameters(), torch_parity.LR,
                           every_k=every_k))
        for x, y in batches:
            step(x, y)
        results.append([p.detach().numpy().copy() for p in
                        list(gen.parameters()) + list(disc.parameters())])
    for a, b in zip(*results):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=2.2e-3)
        loose = np.abs(a - b) > 2e-5 + 5e-3 * np.abs(b)
        assert np.mean(loose) < 1e-3, np.mean(loose)


@pytest.mark.parametrize('s2d', [False, True], ids=['plain', 's2d'])
def test_frozen_encoder_records_no_encoder_backward(s2d, monkeypatch):
    """With ('enc',): no encoder output requires grad, the generator
    loss's autograd graph holds no K2 (ConvNormAct) or K1
    (InstanceNormAct) node, only the decoder's five K3 recomputes run
    (the full step adds K2's at enc3-enc6: at nf=4, enc1 and enc2 have
    fewer than 16 input channels and run the conv, then K1), K3 takes no
    skip gradient, and every
    requires_grad flag is as it was before the step, a frozen parameter
    already off included."""
    state, _ = torch_parity.jax_case(SIZE, ACT, OUT_C, HEAD)
    (x, y), = [(torch_parity.nchw(x), torch_parity.nchw(y))
               for x, y in torch_parity.batches(SIZE, OUT_C, 1)]
    losses, wants = [], []
    gan_losses = port_steps.gan_losses
    recompute = k2_module.recompute_grads

    def spy_losses(*args):
        out = gan_losses(*args)
        losses.append(out[0])
        return out

    def spy_recompute(ctx, g, conv, inputs):
        wants.append((conv.__name__, list(ctx.needs_input_grad)))
        return recompute(ctx, g, conv, inputs)

    spy_recompute.launches = 0   # the count recompute_grads keeps

    monkeypatch.setattr(port_steps, 'gan_losses', spy_losses)
    monkeypatch.setattr(k2_module, 'recompute_grads', spy_recompute)
    monkeypatch.setattr(k3_module, 'recompute_grads', spy_recompute)

    def graph_names(loss):
        seen, todo = set(), [loss.grad_fn]
        while todo:
            node = todo.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            todo.extend(n for n, _ in node.next_functions)
        return {type(n).__name__ for n in seen}

    for freeze in ((), ('enc',)):
        gen, disc = torch_parity.port_models(state, ACT, OUT_C, HEAD)
        if freeze:
            gen.encoder[3].weight.requires_grad_(False)
        outs = []
        for block in gen.encoder:
            block.register_forward_hook(
                lambda m, i, o: outs.append(o.requires_grad))
        opt = make_optimizer(trainable_params(gen, freeze), 1e-3)
        step = make_train_step(gen, disc, opt,
                               make_optimizer(disc.parameters(), 1e-3),
                               s2d=s2d)
        del losses[:], wants[:]
        step(x, y)
        names = graph_names(losses[0])
        flags = [p.requires_grad for p in gen.parameters()]
        if freeze:
            assert len(opt.mu) == 7
            assert outs[:7] == [False] * 7
            assert 'ConvNormActBackward' not in names
            assert 'InstanceNormActBackward' not in names
            assert [w[0] for w in wants] == ['_convt'] * 5
            assert all(not need[2] for _, need in wants)
            assert flags == [True] * 3 + [False] + [True] * 10
        else:
            assert outs[:7] == [True] * 7
            assert 'ConvNormActBackward' in names
            assert sorted(w[0] for w in wants) == \
                ['_conv'] * 4 + ['_convt'] * 5
            assert all(flags)
