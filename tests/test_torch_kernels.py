"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version; the JAX Pallas
functions are called directly and run in interpret mode (their custom
VJPs too: ``_backward_pallas`` for K1, the XLA recompute for K2 and K3).
Same inputs (numpy, seeded) through both, NHWC/HWIO on the JAX side and
NCHW with torch weight layouts on the port's. Tolerances: fp32 rtol 1e-3
/ atol 1e-4; bf16 atol 3e-2 (one bf16 rounding of O(1) outputs, summed
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from patchgan_tpu.ops.pallas.conv_norm_act import fused_conv_norm_act
from patchgan_tpu.ops.pallas.convt_norm_act import fused_convt_norm_act
from patchgan_tpu.ops.pallas.norm_act import instance_norm_act_pallas
from patchgan_tpu.utils.transfer import conv_kernel_to_jax, \
    convT_kernel_to_jax
from patchgan_tpu_torch.ops.kernels import (
    WRAPPERS, conv_norm_act, conv_norm_act_plain, convt_norm_act,
    convt_norm_act_plain, instance_norm_act, instance_norm_act_backward,
    instance_norm_act_backward_plain, instance_norm_act_plain,
    pack_convt_weight_plain, pack_thin_weight_plain, thin_conv3x3,
    thin_conv3x3_plain,
    thin_conv3x3_wgrad, thin_conv3x3_wgrad_plain)

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


# (N, C, H, W) beside an 8x12 plane: the edges of K1's and K1-bwd's launch
# classes (plane_geometry): 4x4 (16 elements: a lane a plane, in a plane
# count no multiple of the planes a block takes), 8x8 and 16x16 (a few
# lanes a plane), 1x3 (no multiple of 16 bytes: element by element)
EDGE_SHAPES = [(3, 5, 4, 4), (2, 8, 8, 8), (2, 4, 16, 16), (2, 8, 1, 3)]


def _shape_id(s):
    """The plane (H x W); the whole shape for the 4x4 edge case."""
    return 'x'.join(map(str, s if s == EDGE_SHAPES[0] else s[2:]))


@pytest.mark.parametrize('shape', [(2, 24, 8, 12)] + EDGE_SHAPES,
                         ids=_shape_id)
@pytest.mark.parametrize('dt', DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize('act', ACTS)
def test_instance_norm_act_matches_pallas(act, dt, shape):
    name, tdt, jdt = dt
    x = _inputs(shape, tdt, 0, scale=3.0) + 1.5
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


@pytest.mark.parametrize('act', ACTS)
def test_packed_convt_weight_products(act):
    """K3's packed weight, read as its GEMM reads it: per output parity
    class g = 2 dy + dx, A[n, 4 ci + 2 ay + ax, t, u] = the zero-padded
    input at (t + dy - ay, u + dx - ax), times wp[g], interleaved into
    [N, Cout, 2H, 2W], equals F.conv_transpose2d. Cx + Cs = 5 puts K = 20
    in a 32-wide packed row, and A past K is ones, so the product is
    right only if the packed tail is zero. After IN + act it equals the
    JAX fused_convt_norm_act (fp32, atol 1e-4)."""
    x = _inputs((2, 3, 6, 10), torch.float32, 30)
    skip = _inputs((2, 2, 6, 10), torch.float32, 31)
    w = _inputs((5, 7, 4, 4), torch.float32, 32, scale=0.3)
    xin = torch.cat([x, skip], 1)
    wp = pack_convt_weight_plain(w)
    n, c, h, wd = xin.shape
    assert wp.shape == (4, 7, 32)
    xp = F.pad(xin, (1, 1, 1, 1))
    got = torch.zeros(n, 7, 2 * h, 2 * wd)
    for g in range(4):
        dy, dx = g >> 1, g & 1
        a = torch.stack([xp[:, :, 1 + dy - ay:1 + dy - ay + h,
                            1 + dx - ax:1 + dx - ax + wd]
                         for ay in (0, 1) for ax in (0, 1)], 2)
        a = torch.cat([a.reshape(n, 4 * c, h, wd),
                       torch.ones(n, 32 - 4 * c, h, wd)], 1)
        got[:, :, dy::2, dx::2] = torch.einsum('nkhw,ok->nohw', a, wp[g])
    want = F.conv_transpose2d(xin, w, stride=2, padding=1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    ours = instance_norm_act_plain(got, 1e-5, act)
    theirs = fused_convt_norm_act(
        jnp.asarray(_nhwc(x)), jnp.asarray(convT_kernel_to_jax(w.numpy())),
        1e-5, act, jnp.asarray(_nhwc(skip)))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(theirs), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize('cin,cout', [(5, 40), (12, 64), (28, 64)])
def test_packed_thin_weight_products(cin, cout, monkeypatch):
    """K4's packed weight, read as its blocks read it: the 3x3 conv is the
    sum over the 9 shifted, zero-padded windows of x (channels padded to
    the packed rows with ones) times the packed [tap][ci][co] slices, and
    equals F.conv2d (fp32, atol 1e-5) only if every padding entry is 0;
    the same output equals the JAX thin_conv3x3 in interpret mode, and
    the padding entries (ci >= Cin, co >= Cout, the row pad) are exactly
    0 in both dtypes."""
    monkeypatch.setenv('PATCHGAN_THIN_CONV', 'interpret')
    from patchgan_tpu.ops.pallas.thin_conv import thin_conv3x3 as jax_thin
    rng = np.random.default_rng(33)
    xa = rng.normal(size=(2, 32, 24, cin)).astype(np.float32)
    wa = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    x = torch.from_numpy(np.transpose(xa, (0, 3, 1, 2)).copy())
    w = torch.from_numpy(np.transpose(wa, (3, 2, 0, 1)).copy())
    wp = pack_thin_weight_plain(w, torch.float32)
    ks = -(-cin // 16) * 16
    assert wp.shape == (1, 9, ks, 64)
    n, _, h, wd = x.shape
    xp = F.pad(torch.cat([x, torch.ones(n, ks - cin, h, wd)], 1),
               (1, 1, 1, 1))
    got = sum(torch.einsum('nkhw,kc->nchw',
                           xp[:, :, r:r + h, s:s + wd], wp[0, 3 * r + s])
              for r in range(3) for s in range(3))
    torch.testing.assert_close(got[:, :cout],
                               F.conv2d(x, w, padding=1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_nhwc(got[:, :cout]),
                               np.asarray(jax_thin(jnp.asarray(xa),
                                                   jnp.asarray(wa))),
                               rtol=1e-4, atol=1e-5)
    for dt in (torch.float32, torch.bfloat16):
        wp = pack_thin_weight_plain(w, dt)
        assert wp.dtype == dt
        assert not wp[:, :, cin:].any() and not wp[..., cout:].any()
        assert torch.equal(wp[0, :, :cin, :cout],
                           w.to(dt).reshape(cout, cin, 9).permute(2, 1, 0))


def test_cpu_tensors_never_launch():
    """A CPU tensor takes the plain version and leaves every launch
    count at 0, and equals that plain version exactly; so does the
    backward, also under autograd."""
    for f in WRAPPERS:
        f.launches = 0
    x = _inputs((1, 16, 8, 8), torch.float32, 6)
    w = _inputs((8, 16, 4, 4), torch.float32, 7, scale=0.1)
    wt = _inputs((16, 8, 4, 4), torch.float32, 8, scale=0.1)
    wc = _inputs((8, 16, 3, 3), torch.float32, 8, scale=0.1)
    assert torch.equal(instance_norm_act(x, 1e-5, 'relu'),
                       instance_norm_act_plain(x, 1e-5, 'relu'))
    assert torch.equal(conv_norm_act(x, w, 1e-5, 'tanh'),
                       conv_norm_act_plain(x, w, 1e-5, 'tanh'))
    assert torch.equal(convt_norm_act(x, wt, 1e-5, 'leakyrelu'),
                       convt_norm_act_plain(x, wt, 1e-5, 'leakyrelu'))
    g = _inputs((1, 16, 8, 8), torch.float32, 9)
    assert torch.equal(instance_norm_act_backward(g, x, 1e-5, 'tanh'),
                       instance_norm_act_backward_plain(g, x, 1e-5, 'tanh'))
    xg = x.clone().requires_grad_()
    conv_norm_act(xg, w.clone().requires_grad_(), 1e-5, 'relu').sum() \
        .backward()
    assert xg.grad is not None
    assert torch.equal(thin_conv3x3(x, wc), thin_conv3x3_plain(x, wc))
    assert torch.equal(thin_conv3x3_wgrad(x, g[:, :8]),
                       thin_conv3x3_wgrad_plain(x, g[:, :8]))
    wg = wc.clone().requires_grad_()
    thin_conv3x3(xg, wg).sum().backward()
    assert wg.grad is not None
    assert [f.launches for f in WRAPPERS] == [0] * len(WRAPPERS) and \
        len(WRAPPERS) == 6


def test_unsupported_activation_raises():
    x = _inputs((1, 4, 4, 4), torch.float32, 9)
    with pytest.raises(ValueError, match='activations'):
        instance_norm_act(x, 1e-5, 'softmax')


def _vjp_nhwc(fn, primals, g):
    """jax.vjp of ``fn`` at NHWC ``primals`` with cotangent g."""
    _, vjp = jax.vjp(fn, *primals)
    return vjp(g)


# (N, C, H, W): H != W, enc6's 2x2 plane at 256 px, its 1x1 plane at
# 128 px (xhat = 0 exactly, where relu' and leakyrelu' differ between
# conventions), and the launch classes' edges
BWD_SHAPES = [(2, 8, 6, 10), (3, 16, 2, 2), (4, 8, 1, 1)] + EDGE_SHAPES


@pytest.mark.parametrize('shape', BWD_SHAPES, ids=_shape_id)
@pytest.mark.parametrize('dt', DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize('act', ACTS)
def test_instance_norm_act_backward_matches_pallas(act, dt, shape):
    """The plain K1 backward (the oracle of K1-bwd on the card) against
    jax.vjp of instance_norm_act_pallas, whose backward on the CPU is
    ``_backward_pallas`` in interpret mode; and InstanceNormAct's
    backward is that plain version."""
    name, tdt, jdt = dt
    x = _inputs(shape, tdt, 10, scale=2.0) + 0.5
    g = _inputs(shape, tdt, 11)
    got = instance_norm_act_backward(g, x, 1e-5, act)
    assert got.dtype == tdt
    want, = _vjp_nhwc(lambda a: instance_norm_act_pallas(a, 1e-5, act),
                      (jnp.asarray(_nhwc(x), jdt),),
                      jnp.asarray(_nhwc(g), jdt))
    _close(got, want, name)
    xg = x.clone().requires_grad_()
    dx, = torch.autograd.grad(instance_norm_act(xg, 1e-5, act), xg, g)
    assert torch.equal(dx, got)


def _grad_close(got, want, layout):
    """fp32 comparison of a torch gradient with a JAX one; ``layout``
    maps the torch array to the JAX layout."""
    np.testing.assert_allclose(layout(got.numpy()), np.asarray(want),
                               rtol=1e-3, atol=1e-4)


def _act_nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


@pytest.mark.parametrize('act', ACTS)
def test_conv_norm_act_grads_match_jax(act):
    """ConvNormAct's dx and dw (recompute + plain K1 backward on the
    CPU) against jax.vjp of fused_conv_norm_act, fp32."""
    x = _inputs((2, 16, 8, 12), torch.float32, 12).requires_grad_()
    w = _inputs((8, 16, 4, 4), torch.float32, 13, scale=0.1) \
        .requires_grad_()
    g = _inputs((2, 8, 4, 6), torch.float32, 14)
    dx, dw = torch.autograd.grad(conv_norm_act(x, w, 1e-5, act), (x, w), g)
    jdx, jdw = _vjp_nhwc(
        lambda a, b: fused_conv_norm_act(a, b, 1e-5, act),
        (jnp.asarray(_nhwc(x.detach())),
         jnp.asarray(conv_kernel_to_jax(w.detach().numpy()))),
        jnp.asarray(_nhwc(g)))
    _grad_close(dx, jdx, _act_nhwc)
    _grad_close(dw, jdw, conv_kernel_to_jax)


@pytest.mark.parametrize('with_skip', [True, False], ids=['skip', 'noskip'])
@pytest.mark.parametrize('act', ACTS)
def test_convt_norm_act_grads_match_jax(act, with_skip):
    """ConvTNormAct's dx, dw and dskip against jax.vjp of
    fused_convt_norm_act, fp32, on a 6x10 input."""
    x = _inputs((2, 16, 6, 10), torch.float32, 15).requires_grad_()
    skip = _inputs((2, 8, 6, 10), torch.float32, 16).requires_grad_() \
        if with_skip else None
    w = _inputs((16 + (8 if with_skip else 0), 8, 4, 4), torch.float32, 17,
                scale=0.1).requires_grad_()
    g = _inputs((2, 8, 12, 20), torch.float32, 18)
    ins = (x, w) + ((skip,) if with_skip else ())
    got = torch.autograd.grad(convt_norm_act(x, w, 1e-5, act, skip), ins, g)
    jins = (jnp.asarray(_nhwc(x.detach())),
            jnp.asarray(convT_kernel_to_jax(w.detach().numpy())))
    if with_skip:
        jins += (jnp.asarray(_nhwc(skip.detach())),)
    want = _vjp_nhwc(
        lambda *a: fused_convt_norm_act(a[0], a[1], 1e-5, act,
                                        a[2] if with_skip else None),
        jins, jnp.asarray(_nhwc(g)))
    _grad_close(got[0], want[0], _act_nhwc)
    _grad_close(got[1], want[1], convT_kernel_to_jax)
    if with_skip:
        _grad_close(got[2], want[2], _act_nhwc)


@pytest.mark.parametrize('dt', DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize('act', ACTS)
def test_backward_at_xhat_zero_matches_pallas(act, dt):
    """Planes (-a, 0, a) normalise to xhat = 0 exactly in the middle,
    where act'(0) enters dx: relu' = 0 and leakyrelu' = 1, as in the JAX
    package's _act_grad (a 1x1 plane cannot show it: its dx is 0 for any
    act')."""
    name, tdt, jdt = dt
    a = np.random.default_rng(19).uniform(0.5, 2.0, size=(2, 4, 1, 1))
    x = torch.from_numpy(np.concatenate([-a, 0 * a, a], axis=3)
                         .astype(np.float32)).to(tdt)
    g = _inputs((2, 4, 1, 3), tdt, 20)
    got = instance_norm_act_backward(g, x, 1e-5, act)
    want, = _vjp_nhwc(lambda v: instance_norm_act_pallas(v, 1e-5, act),
                      (jnp.asarray(_nhwc(x), jdt),),
                      jnp.asarray(_nhwc(g), jdt))
    _close(got, want, name)


@pytest.mark.parametrize('cin,cout', [(12, 64), (28, 64), (4, 64)])
def test_thin_conv_matches_pallas(cin, cout, monkeypatch):
    """The plain K4 and K4-wgrad (the kernels' oracles on the card),
    through ThinConv3x3 on CPU tensors, against the JAX thin_conv3x3 in
    interpret mode (H a multiple of its 32-row chunk): the forward, and dx
    and dw of sum(sin(f)), fp32, at the tolerances of
    tests/test_pallas.py:264-287."""
    monkeypatch.setenv('PATCHGAN_THIN_CONV', 'interpret')
    from patchgan_tpu.ops.pallas.thin_conv import thin_conv3x3 as jax_thin
    rng = np.random.default_rng(21)
    xa = rng.normal(size=(2, 32, 24, cin)).astype(np.float32)
    wa = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    x = torch.from_numpy(np.transpose(xa, (0, 3, 1, 2)).copy()) \
        .requires_grad_()
    w = torch.from_numpy(np.transpose(wa, (3, 2, 0, 1)).copy()) \
        .requires_grad_()
    y = thin_conv3x3(x, w)
    np.testing.assert_allclose(_nhwc(y.detach()),
                               np.asarray(jax_thin(jnp.asarray(xa),
                                                   jnp.asarray(wa))),
                               rtol=1e-4, atol=1e-5)
    dx, dw = torch.autograd.grad(torch.sin(y).sum(), (x, w))
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(jnp.sin(jax_thin(a, b))),
                        (0, 1))(jnp.asarray(xa), jnp.asarray(wa))
    np.testing.assert_allclose(_nhwc(dx), np.asarray(jdx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.transpose(dw.numpy(), (2, 3, 1, 0)),
                               np.asarray(jdw), rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize('wants', ['x', 'w', 'both'])
def test_thin_conv_grads_match_autograd(wants):
    """ThinConv3x3's gradients on CPU tensors against autograd of
    F.conv2d, fp32, for each set of inputs that require a gradient; an
    input that requires none gets none."""
    x = _inputs((2, 12, 10, 14), torch.float32, 22)
    w = _inputs((20, 12, 3, 3), torch.float32, 23, scale=0.1)
    g = _inputs((2, 20, 10, 14), torch.float32, 24)
    need = {'x': (True, False), 'w': (False, True), 'both': (True, True)}
    ins = [t.clone().requires_grad_(r) for t, r in zip((x, w), need[wants])]
    ref = [t.clone().requires_grad_(r) for t, r in zip((x, w), need[wants])]
    thin_conv3x3(*ins).backward(g)
    torch.nn.functional.conv2d(*ref, padding=1).backward(g)
    for got, want in zip(ins, ref):
        assert (got.grad is None) == (want.grad is None)
        if want.grad is not None:
            np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                       rtol=1e-4, atol=1e-4)
