"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version; the JAX Pallas
functions are called directly and run in interpret mode. Same inputs
(numpy, seeded) through both, NHWC/HWIO on the JAX side and NCHW with
torch weight layouts on the port's. Tolerances: fp32 rtol 1e-3 /
atol 1e-4; bf16 atol 3e-2 (one bf16 rounding of O(1) outputs, summed in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchgan_tpu.ops.pallas.conv_norm_act import fused_conv_norm_act
from patchgan_tpu.ops.pallas.convt_norm_act import fused_convt_norm_act
from patchgan_tpu.ops.pallas.norm_act import instance_norm_act_pallas
from patchgan_tpu.utils.transfer import conv_kernel_to_jax, \
    convT_kernel_to_jax
from patchgan_tpu_torch.ops.kernels import (
    WRAPPERS, conv_norm_act, conv_norm_act_plain, convt_norm_act,
    convt_norm_act_plain, instance_norm_act, instance_norm_act_plain)

torch.set_num_threads(2)

ACTS = [None, 'tanh', 'relu', 'leakyrelu']
DTYPES = [('float32', torch.float32, jnp.float32),
          ('bfloat16', torch.bfloat16, jnp.bfloat16)]


def _nhwc(t):
    return np.transpose(t.float().numpy(), (0, 2, 3, 1))


def _close(got, want, name):
    got = np.transpose(got.float().numpy(), (0, 2, 3, 1))
    want = np.asarray(want, dtype=np.float32)
    if name == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)


def _inputs(shape, tdtype, seed, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a * scale).to(tdtype)


@pytest.mark.parametrize('dt', DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize('act', ACTS)
def test_instance_norm_act_matches_pallas(act, dt):
    name, tdt, jdt = dt
    x = _inputs((2, 24, 8, 12), tdt, 0, scale=3.0) + 1.5
    got = instance_norm_act(x, 1e-5, act)
    want = instance_norm_act_pallas(jnp.asarray(_nhwc(x), jdt), 1e-5, act)
    assert got.dtype == tdt
    _close(got, want, name)


@pytest.mark.parametrize('dt', DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize('act', ACTS)
def test_conv_norm_act_matches_pallas(act, dt):
    name, tdt, jdt = dt
    x = _inputs((2, 16, 16, 16), tdt, 1)
    w = _inputs((32, 16, 4, 4), tdt, 2, scale=0.1)
    got = conv_norm_act(x, w, 1e-5, act)
    want = fused_conv_norm_act(
        jnp.asarray(_nhwc(x), jdt),
        jnp.asarray(conv_kernel_to_jax(w.float().numpy()), jdt), 1e-5, act)
    assert got.shape == (2, 32, 8, 8) and got.dtype == tdt
    _close(got, want, name)


@pytest.mark.parametrize('with_skip', [True, False], ids=['skip', 'noskip'])
@pytest.mark.parametrize('dt', DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize('act', ACTS)
def test_convt_norm_act_matches_pallas(act, dt, with_skip):
    """6x10 input (H != W), so a tap or parity mix-up cannot cancel."""
    name, tdt, jdt = dt
    x = _inputs((2, 16, 6, 10), tdt, 3)
    skip = _inputs((2, 8, 6, 10), tdt, 4) if with_skip else None
    cin = 16 + (8 if with_skip else 0)
    w = _inputs((cin, 32, 4, 4), tdt, 5, scale=0.1)
    got = convt_norm_act(x, w, 1e-5, act, skip)
    want = fused_convt_norm_act(
        jnp.asarray(_nhwc(x), jdt),
        jnp.asarray(convT_kernel_to_jax(w.float().numpy()), jdt), 1e-5, act,
        jnp.asarray(_nhwc(skip), jdt) if with_skip else None)
    assert got.shape == (2, 32, 12, 20) and got.dtype == tdt
    _close(got, want, name)


def test_cpu_tensors_never_launch():
    """A CPU tensor takes the plain version and leaves every launch
    count at 0, and equals that plain version exactly."""
    for f in WRAPPERS:
        f.launches = 0
    x = _inputs((1, 16, 8, 8), torch.float32, 6)
    w = _inputs((8, 16, 4, 4), torch.float32, 7, scale=0.1)
    wt = _inputs((16, 8, 4, 4), torch.float32, 8, scale=0.1)
    assert torch.equal(instance_norm_act(x, 1e-5, 'relu'),
                       instance_norm_act_plain(x, 1e-5, 'relu'))
    assert torch.equal(conv_norm_act(x, w, 1e-5, 'tanh'),
                       conv_norm_act_plain(x, w, 1e-5, 'tanh'))
    assert torch.equal(convt_norm_act(x, wt, 1e-5, 'leakyrelu'),
                       convt_norm_act_plain(x, wt, 1e-5, 'leakyrelu'))
    assert [f.launches for f in WRAPPERS] == [0, 0, 0]


def test_unsupported_activation_raises():
    x = _inputs((1, 4, 4, 4), torch.float32, 9)
    with pytest.raises(ValueError, match='activations'):
        instance_norm_act(x, 1e-5, 'softmax')
