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
