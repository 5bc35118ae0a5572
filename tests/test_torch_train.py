"""The port's Discriminator, Adam and G+D step against the JAX package.

The step case here runs at 256 px, where enc6's plane is 2x2; the 128-px
cases are in test_torch_step.py (each file compiles its own JAX step).
Tolerances: forward fp32 rtol 1e-3 / atol 1e-4 (bf16 atol 3e-2); Adam
rtol 1e-6 against optax; step losses rtol 2e-3 / atol 2e-4 and updated
parameters within Adam's step-1 sign-flip bound
(tests/test_train_step_parity.py:109-129).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity
from patchgan_tpu.models import Discriminator as JaxDisc
from patchgan_tpu.train.steps import make_optimizer as jax_make_optimizer
from patchgan_tpu.utils.transfer import disc_key_map as jax_disc_key_map
from patchgan_tpu_torch.models import Discriminator
from patchgan_tpu_torch.train.steps import make_optimizer
from patchgan_tpu_torch.utils.summary import count_params
from patchgan_tpu_torch.utils.transfer import state_dict_from_jax

torch.set_num_threads(2)


@pytest.mark.parametrize('norm', [False, True], ids=['plain', 'norm'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_discriminator_matches_jax(dtype, norm):
    """Forward on (image, mask) from one JAX-initialised parameter tree,
    the state_dict keys of utils/transfer.py:74-99 and equal parameter
    counts."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(30)
    x = rng.uniform(size=(2, 64, 48, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 64, 48, 2)).astype(np.float32)
    jdisc = JaxDisc(input_nc=5, ndf=8, n_layers=3, norm=norm, dtype=jdt,
                    use_pallas=False)
    params = jax.jit(jdisc.init)(jax.random.PRNGKey(0), x, y)['params']
    want = np.asarray(jdisc.apply({'params': params}, x, y))
    disc = Discriminator(5, ndf=8, n_layers=3, norm=norm, dtype=tdt)
    sd = state_dict_from_jax(jax.device_get(params), norm=norm)
    assert set(sd) == set(jax_disc_key_map(3, norm)) == \
        set(disc.state_dict())
    disc.load_state_dict(sd)
    assert count_params(disc) == sum(
        np.size(v) for v in jax.tree_util.tree_leaves(params))
    got = disc(torch_parity.nchw(x), torch_parity.nchw(y))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 6, 4)
    got = np.transpose(got.detach().numpy(), (0, 2, 3, 1))
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)


@pytest.mark.parametrize('mu_dtype', ['float32', 'bfloat16'])
def test_adam_matches_optax(mu_dtype):
    """Four steps of the port's Adam against the JAX package's
    make_optimizer (optax.adam with fp32 hyperparameters), with the
    first moment in fp32 or bf16, a learning-rate change between steps
    included."""
    rng = np.random.default_rng(31)
    shapes = [(4, 3, 2, 2), (7,), (5, 5)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10.0 ** -k
              for k, s in enumerate(shapes)] for _ in range(4)]
    tx = jax_make_optimizer(1e-3, mu_dtype=getattr(jnp, mu_dtype))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    params = [torch.from_numpy(p.copy()) for p in p0]
    opt = make_optimizer(params, 1e-3, mu_dtype=getattr(torch, mu_dtype))
    for i, g in enumerate(grads):
        lr = 1e-3 if i < 2 else 5e-4
        state.hyperparams['learning_rate'] = np.float32(lr)
        opt.lr = lr
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(a) for a in g])
        for want, got in zip(jp, params):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)
    for want, got in zip(state.inner_state[0].mu, opt.mu):
        assert got.dtype == getattr(torch, mu_dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-6 if mu_dtype == 'float32'
                                   else 1e-2)


@pytest.mark.parametrize('steps', [1, 4])
def test_train_step_matches_jax_256px(steps):
    """nf=4, batch 2, 256 px (enc6 on a 2x2 plane), relu, 3 classes,
    softmax head, tversky * 200 + BCE: losses of every step, and after
    the first step every generator and discriminator parameter."""
    jl, pl, first = torch_parity.run(256, 'relu', 3, 'softmax', steps)
    torch_parity.assert_losses_close(jl, pl)
    jg, jd, tg, td = first
    torch_parity.assert_params_close(jg, tg)
    torch_parity.assert_params_close(jd, td)
