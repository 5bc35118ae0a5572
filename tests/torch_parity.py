"""Shared set-up of the port's G+D step tests: the same nf=4 models and
batches through the JAX package's ``make_train_step`` and the port's.

Weights are initialised by the JAX package and carried into the port
through ``state_dict_from_jax``; batches come from numpy with a seed;
dropout is off (the two packages' RNG streams differ).
"""

import functools

import jax
import numpy as np
import torch

LR = 1e-3
NF = 4
BATCH = 2


@functools.lru_cache(maxsize=None)
def jax_case(size, act, out_c, final_act, s2d=False, freeze=(), every_k=1):
    """(initial JAX TrainState, jitted JAX step) of one configuration,
    built once per process; ``s2d`` steps through clones of the models in
    the space-to-depth form (the same parameter tree); ``freeze`` and
    ``every_k`` go to both optimizers and the step as the JAX Trainer
    passes them."""
    from patchgan_tpu.models import Discriminator, UNet
    from patchgan_tpu.train.steps import (init_train_state, make_optimizer,
                                          make_train_step)
    gen = UNet(input_nc=3, output_nc=out_c, nf=NF, activation=act,
               final_act=final_act, use_dropout=False, use_pallas=False)
    disc = Discriminator(input_nc=3 + out_c, ndf=NF, n_layers=3,
                         use_pallas=False)
    gtx = make_optimizer(LR, freeze_patterns=freeze, every_k=every_k)
    dtx = make_optimizer(LR, every_k=every_k)
    state = init_train_state(gen, disc, (1, size, size, 3), out_c, gtx,
                             dtx, seed=0)
    if s2d:
        gen, disc = gen.clone(s2d=True), disc.clone(s2d=True)
    step = jax.jit(make_train_step(gen, disc, gtx, dtx, loss_type='tversky',
                                   seg_alpha=200.0, freeze_patterns=freeze))
    return state, step


def port_models(state, act, out_c, final_act):
    """The port's UNet and Discriminator holding the JAX state's
    weights."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.utils.transfer import state_dict_from_jax
    gen = UNet(3, out_c, nf=NF, activation=act, final_act=final_act)
    disc = Discriminator(3 + out_c, ndf=NF, n_layers=3)
    gen.load_state_dict(state_dict_from_jax(jax.device_get(state.g_params)))
    disc.load_state_dict(state_dict_from_jax(
        jax.device_get(state.d_params)))
    return gen, disc


def batches(size, out_c, steps, seed=0):
    """NHWC numpy (x, y) pairs: uniform images, one-hot (or binary for
    one class) masks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        x = rng.uniform(size=(BATCH, size, size, 3)).astype(np.float32)
        if out_c == 1:
            y = (rng.uniform(size=(BATCH, size, size, 1)) > 0.5)
        else:
            y = np.eye(out_c)[rng.integers(0, out_c, (BATCH, size, size))]
        out.append((x, y.astype(np.float32)))
    return out


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a,
                                                              (0, 3, 1, 2))))


def run(size, act, out_c, final_act, steps, s2d=False):
    """Run ``steps`` G+D steps in both packages on the same batches, in
    the form ``s2d`` says.
    Returns (jax losses per step, port losses per step, JAX state after
    the first step, port generator and discriminator state_dicts after
    the first step)."""
    from patchgan_tpu_torch.train.steps import (make_optimizer,
                                                make_train_step)
    from patchgan_tpu_torch.utils.transfer import state_dict_from_jax
    state, step = jax_case(size, act, out_c, final_act, s2d)
    gen, disc = port_models(state, act, out_c, final_act)
    port_step = make_train_step(gen, disc,
                                make_optimizer(gen.parameters(), LR),
                                make_optimizer(disc.parameters(), LR),
                                loss_type='tversky', seg_alpha=200.0,
                                s2d=s2d)
    jl, pl, first = [], [], None
    for i, (x, y) in enumerate(batches(size, out_c, steps)):
        state, losses = step(state, x, y)
        jl.append({k: float(v) for k, v in losses.items()})
        pl.append({k: float(v) for k, v in port_step(nchw(x),
                                                     nchw(y)).items()})
        if i == 0:
            first = (state_dict_from_jax(jax.device_get(state.g_params)),
                     state_dict_from_jax(jax.device_get(state.d_params)),
                     {k: v.clone() for k, v in gen.state_dict().items()},
                     {k: v.clone() for k, v in disc.state_dict().items()})
    return jl, pl, first


def assert_losses_close(jl, pl, rtol=2e-3, atol=2e-4):
    for i, (want, got) in enumerate(zip(jl, pl)):
        assert got['gen'] == got['gen_loss']
        for key in ('gen', 'gdisc', 'discr', 'discf', 'disc'):
            np.testing.assert_allclose(
                got[key], want[key], rtol=rtol, atol=atol,
                err_msg=f'loss {key} at step {i + 1}')


def assert_params_close(want, got):
    """After Adam's first step the update is about lr * sign(g), so an
    element whose gradient is at rounding-noise level can flip: 99.9% of
    the elements tight and every one within 2.5 lr
    (tests/test_train_step_parity.py:114-129)."""
    assert set(want) == set(got)
    for key in want:
        w, g = want[key].numpy(), got[key].numpy()
        diff = np.abs(w - g)
        tight = diff <= 5e-5 + 5e-3 * np.abs(w)
        assert np.mean(tight) >= 0.999, f'{key}: {np.mean(~tight):.2%} loose'
        assert diff.max() <= 2.5 * LR, f'{key}: max diff {diff.max():.2e}'
