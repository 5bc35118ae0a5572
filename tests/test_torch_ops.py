"""The port's ops against the JAX package's ops, fp32 (NCHW vs NHWC,
torch weight layouts vs HWIO). Tolerance rtol 1e-3 / atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchgan_tpu.ops.activations import apply_activation as jax_act
from patchgan_tpu.ops.conv import conv2d as jax_conv2d
from patchgan_tpu.ops.conv import conv_transpose2d as jax_convt
from patchgan_tpu.ops.norm import instance_norm as jax_instance_norm
from patchgan_tpu.utils.transfer import conv_kernel_to_jax, \
    convT_kernel_to_jax
from patchgan_tpu_torch.ops import (apply_activation, conv2d,
                                    conv_transpose2d, instance_norm)

torch.set_num_threads(2)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _nhwc(a):
    return jnp.asarray(np.transpose(a, (0, 2, 3, 1)))


def _check(got, want):
    np.testing.assert_allclose(np.transpose(got.numpy(), (0, 2, 3, 1)),
                               np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize('act', [None, 'linear', 'tanh', 'relu',
                                 'leakyrelu', 'softmax', 'sigmoid'])
def test_activations_match_jax(act):
    x = _rand((2, 5, 6, 7), 0, scale=4.0)
    _check(apply_activation(torch.from_numpy(x), act),
           jax_act(_nhwc(x), act))


@pytest.mark.parametrize('act', [None, 'tanh', 'relu', 'leakyrelu'])
def test_instance_norm_matches_jax(act):
    x = _rand((2, 6, 5, 9), 1, scale=2.0) + 3.0
    _check(instance_norm(torch.from_numpy(x), 1e-5, act),
           jax_instance_norm(_nhwc(x), 1e-5, act, use_pallas=False))


@pytest.mark.parametrize('with_x2', [False, True], ids=['single', 'x2'])
def test_conv2d_matches_jax(with_x2):
    x = _rand((2, 5, 12, 8), 2)
    x2 = _rand((2, 3, 12, 8), 3) if with_x2 else None
    w = _rand((7, 5 + (3 if with_x2 else 0), 4, 4), 4, scale=0.2)
    got = conv2d(torch.from_numpy(x), torch.from_numpy(w),
                 x2=torch.from_numpy(x2) if with_x2 else None)
    want = jax_conv2d(_nhwc(x), jnp.asarray(conv_kernel_to_jax(w)),
                      x2=_nhwc(x2) if with_x2 else None)
    assert got.shape == (2, 7, 6, 4)
    _check(got, want)


@pytest.mark.parametrize('segregated', [False, True], ids=['dilated',
                                                           'segregated'])
@pytest.mark.parametrize('with_x2', [False, True], ids=['single', 'x2'])
def test_conv_transpose2d_matches_jax(with_x2, segregated):
    x = _rand((2, 5, 6, 10), 5)
    x2 = _rand((2, 3, 6, 10), 6) if with_x2 else None
    w = _rand((5 + (3 if with_x2 else 0), 7, 4, 4), 7, scale=0.2)
    got = conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w),
                           x2=torch.from_numpy(x2) if with_x2 else None)
    want = jax_convt(_nhwc(x), jnp.asarray(convT_kernel_to_jax(w)),
                     x2=_nhwc(x2) if with_x2 else None,
                     segregated=segregated)
    assert got.shape == (2, 7, 12, 20)
    _check(got, want)


def _probs(shape, seed):
    return np.random.default_rng(seed).uniform(0.02, 0.98, size=shape) \
        .astype(np.float32)


def _onehot(shape, seed):
    n, c, h, w = shape
    labels = np.random.default_rng(seed).integers(0, c, size=(n, h, w))
    return np.transpose(np.eye(c, dtype=np.float32)[labels], (0, 3, 1, 2))


LOSSES = ['tversky', 'tversky_per_sample', 'fc_tversky',
          'fc_tversky_per_sample', 'mae', 'bce', 'weighted_bce']


@pytest.mark.parametrize('loss', LOSSES)
def test_losses_match_jax(loss):
    """Every loss of ops/losses.py, value and gradient w.r.t. the
    prediction, fp32 (NCHW vs NHWC)."""
    from patchgan_tpu.ops import losses as jl
    import jax
    from patchgan_tpu_torch.ops import losses as tl
    shape = (2, 3, 6, 5)
    p, t = _probs(shape, 20), _onehot(shape, 21)
    wgt = _probs((2, 3, 1, 1), 22)
    fns = {
        'tversky': (lambda a, b: tl.tversky(b, a, 0.75),
                    lambda a, b: jl.tversky(b, a, 0.75)),
        'tversky_per_sample': (
            lambda a, b: tl.tversky(b, a, 0.7, batch_mean=False).sum(),
            lambda a, b: jl.tversky(b, a, 0.7, batch_mean=False).sum()),
        'fc_tversky': (lambda a, b: tl.fc_tversky(b, a, 0.75, 0.75),
                       lambda a, b: jl.fc_tversky(b, a, 0.75, 0.75)),
        'fc_tversky_per_sample': (
            lambda a, b: tl.fc_tversky(b, a, 0.6, 0.5,
                                       batch_mean=False).sum(),
            lambda a, b: jl.fc_tversky(b, a, 0.6, 0.5,
                                       batch_mean=False).sum()),
        'mae': (lambda a, b: tl.mae_loss(b, a),
                lambda a, b: jl.mae_loss(b, a)),
        'bce': (tl.bce_loss, jl.bce_loss),
        'weighted_bce': (
            lambda a, b: tl.weighted_bce_loss(a, b, torch.from_numpy(wgt)),
            lambda a, b: jl.weighted_bce_loss(a, b, _nhwc(wgt))),
    }
    tfn, jfn = fns[loss]
    pt = torch.from_numpy(p).requires_grad_()
    got = tfn(pt, torch.from_numpy(t))
    got_g, = torch.autograd.grad(got, pt)
    want, want_g = jax.value_and_grad(jfn)(_nhwc(p), _nhwc(t))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                               atol=1e-6)
    _check(got_g, want_g)


def test_bce_gradient_at_zero_matches_bce_loss():
    """At p = 0 against target 1 (a saturated discriminator) the clamped
    log gives torch.nn.BCELoss's value 100 and a zero, NaN-free gradient
    (BCELoss's own is -1/(4e-12) there); against target 0 the gradient
    is the slope of -log(1 - p), 1/N (as at p = 1 against target 1, where
    BCELoss gives 0); inside (0, 1) it is BCELoss's."""
    from patchgan_tpu_torch.ops.losses import bce_loss
    p = torch.tensor([0.0, 0.0, 0.3, 1.0])
    t = torch.tensor([0.0, 1.0, 1.0, 1.0])
    ours = p.clone().requires_grad_()
    theirs = p.clone().requires_grad_()
    a = bce_loss(ours, t)
    b = torch.nn.BCELoss()(theirs, t)
    a.backward()
    b.backward()
    torch.testing.assert_close(a, b)
    assert torch.isfinite(ours.grad).all()
    assert ours.grad[1] == 0 and ours.grad[0] == 0.25
    assert ours.grad[3] == -0.25
    torch.testing.assert_close(ours.grad[2], theirs.grad[2])


@pytest.mark.parametrize('stride', [1, 2])
def test_conv2d_bias_and_stride_match_jax(stride):
    """The discriminator's form: bias, stride 1 or 2, padding 1."""
    x = _rand((2, 5, 12, 8), 23)
    w = _rand((7, 5, 4, 4), 24, scale=0.2)
    b = _rand((7,), 25)
    got = conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                 padding=1, bias=torch.from_numpy(b))
    want = jax_conv2d(_nhwc(x), jnp.asarray(conv_kernel_to_jax(w)),
                      stride=stride, padding=1, bias=jnp.asarray(b))
    _check(got, want)


def test_leakyrelu_gradient_at_zero_is_one():
    """jax.nn.leaky_relu's convention, not F.leaky_relu's 0.2."""
    x = torch.zeros(3, requires_grad=True)
    apply_activation(x, 'leakyrelu').sum().backward()
    assert torch.equal(x.grad, torch.ones(3))
