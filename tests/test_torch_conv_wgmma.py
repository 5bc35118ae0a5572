"""The NHWC forms' GEMM cores of K2 and K3 on the CPU: the host planner
(``nhwc_gemm_plan``), the private ``_nhwc_core`` argument, and a plain
PyTorch emulation of the wgmma core's sum order held against the JAX
package's Pallas kernels.

The wgmma core (``csrc/conv_wgmma.cuh``) runs only on the card; here its
arithmetic is replayed in the order it takes: per output class, tiles of
64 rows packing 64 / M samples where a sample has M < 64 pixels, K steps
of 64 channels of one tap (K2: 16 taps x Cin / 64; K3: 4 taps x (Cx /
64 chunks of x, then Cs / 64 of skip)), each K split's share into its
own slice, the slices added in order, the per-(sample, channel) partials
reduced as ``reduce_parts`` reduces them (lane-strided sums, then an xor
butterfly). After instance norm and activation it must equal the JAX
``fused_conv_norm_act`` / ``fused_convt_norm_act`` (interpret mode on the
CPU) in fp32 within rtol 1e-3 / atol 1e-4.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from patchgan_tpu.ops.pallas.conv_norm_act import fused_conv_norm_act
from patchgan_tpu.ops.pallas.convt_norm_act import fused_convt_norm_act
from patchgan_tpu.utils.transfer import conv_kernel_to_jax, \
    convT_kernel_to_jax
from patchgan_tpu_torch.ops.kernels import (conv_norm_act,
                                            conv_norm_act_plain,
                                            convt_norm_act,
                                            convt_norm_act_plain,
                                            pack_convt_weight_nhwc_plain)
from patchgan_tpu_torch.ops.kernels.norm_act import (act_code,
                                                     nhwc_segments)

k2m = importlib.import_module('patchgan_tpu_torch.ops.kernels.conv_norm_act')
k3m = importlib.import_module(
    'patchgan_tpu_torch.ops.kernels.convt_norm_act')

torch.set_num_threads(2)
BF16 = torch.bfloat16
NF = 64
SMEM_PER_BLOCK = 232448   # an H100 block's shared memory


# config 2's step at batch 16, 256 px: K2 enc1-enc6 (Cin, H, Cout), K3
# dec1-dec5 (Cx, Cs, H, Cout)
K2_LEVELS = [(f'enc{i}', cin, 256 >> i, cout) for i, (cin, cout) in
             enumerate([(NF, 2 * NF), (2 * NF, 4 * NF), (4 * NF, 8 * NF),
                         (8 * NF, 8 * NF), (8 * NF, 8 * NF),
                         (8 * NF, 8 * NF)], 1)]
K3_LEVELS = [(f'dec{i}', cx, cs, 256 >> (7 - i), cout) for i, cx, cs, cout in
             [(1, 8 * NF, 8 * NF, 8 * NF), (2, 8 * NF, 8 * NF, 8 * NF),
              (3, 8 * NF, 8 * NF, 4 * NF), (4, 4 * NF, 4 * NF, 2 * NF),
              (5, 2 * NF, 2 * NF, NF)]]


def _plan(kind, n, shape, core=None, split_batch=None, dtype=BF16,
          aligned=True):
    if kind == 'K2':
        cin, h, cout = shape
        return k2m.conv_nhwc_plan(n, cin, h, h, cout, dtype, aligned,
                                  split_batch, core)
    cx, cs, h, cout = shape
    return k3m.convt_nhwc_plan(n, cx, cs, h, h, cout, dtype, aligned,
                               split_batch, core)


def _m(kind, shape):
    """Pixels of one (sample, class) product."""
    h = shape[1] if kind == 'K2' else shape[2]
    return (h // 2) ** 2 if kind == 'K2' else h * h


LEVELS = [('K2', label, shape) for label, *shape in K2_LEVELS] + \
    [('K3', label, shape) for label, *shape in K3_LEVELS]


@pytest.mark.parametrize('kind,label,shape', LEVELS,
                         ids=[lv[1] for lv in LEVELS])
def test_planner_takes_the_wgmma_core_at_config_2(kind, label, shape):
    """Every K2 and K3 level of config 2's step at batch 16 in bf16 takes
    the wgmma core, fits a block's shared memory, packs 64 / M samples a
    tile where M < 64, and gets a K split that does not change with the
    batch at a fixed split_batch."""
    plan = _plan(kind, 16, shape)
    m = _m(kind, shape)
    cout = shape[-1]
    assert plan.core == 'wgmma'
    assert 0 < plan.smem <= SMEM_PER_BLOCK
    assert plan.bn in (64, 128) and cout % plan.bn == 0
    assert plan.stages in (3, 4)
    if m < 64:
        assert plan.samples == 64 // m and plan.tiles == 1
    else:
        assert plan.samples == 1 and plan.tiles == -(-m // 64)
    groups = 1 if kind == 'K2' else 4
    assert plan.parts == groups * plan.tiles
    splits = {_plan(kind, n, shape, split_batch=16).splits
              for n in (1, 3, 16, 64)}
    assert splits == {plan.splits}
    # each split keeps at least WGMMA_MIN_STEPS K steps of 64 channels
    steps = (16 * shape[0] if kind == 'K2'
             else 4 * (shape[0] + shape[1])) // 64
    assert steps // plan.splits >= k2m.WGMMA_MIN_STEPS
    # a smaller split batch splits K as far or further
    assert _plan(kind, 16, shape, split_batch=8).splits >= plan.splits


# chip_smoke.py's element-path cases and what the wgmma core refuses:
# (kind, shape, dtype, aligned)
WMMA_CASES = [
    ('K2', (NF, 64, 2 * NF), torch.float32, True),          # fp32
    ('K3', (4 * NF, 4 * NF, 32, 2 * NF), torch.float32, True),
    ('K2', (16, 24, 40), BF16, True),                       # Cin 16
    ('K2', (48, 16, 64), BF16, True),                       # Cin 48
    ('K3', (13, 6, 12, 40), BF16, True),                    # ragged
    ('K3', (64, 0, 8, 32), BF16, True),                     # Cout 32
    ('K2', (NF, 64, 2 * NF), BF16, False),   # one element past 16 bytes
    ('K3', (2 * NF, 2 * NF, 64, NF), BF16, False)]


@pytest.mark.parametrize('kind,shape,dtype,aligned', WMMA_CASES)
def test_planner_takes_the_wmma_core_elsewhere(kind, shape, dtype,
                                               aligned):
    """fp32, channel runs that are no multiple of 64 and pointers off 16
    bytes take the WMMA core, with choose_splits' split; forcing the
    wgmma core there raises."""
    plan = _plan(kind, 4, shape, dtype=dtype, aligned=aligned)
    assert plan.core == 'wmma' and plan.smem == 0
    assert plan.tiles == -(-_m(kind, shape) // 64)
    with pytest.raises(ValueError, match='wgmma core cannot'):
        _plan(kind, 4, shape, 'wgmma', dtype=dtype, aligned=aligned)
    assert _plan(kind, 4, shape, 'wmma', dtype=dtype,
                 aligned=aligned) == plan


def test_wmma_split_mirrors_choose_splits():
    """The planner's WMMA split is conv_gemm.cuh's choose_splits (the C
    entry point refuses any other): enc4 of the 8-tile chunk (64 tiles,
    256 K steps of 32) doubles while under 528 blocks, to 16; enc1 (1024
    tiles) does not split."""
    assert _plan('K2', 8, (8 * NF, 16, 8 * NF), 'wmma').splits == 16
    assert _plan('K2', 8, (NF, 128, 2 * NF), 'wmma').splits == 1


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _conv_args(dtype, cin=64, h=8, cout=64, layout=_cl):
    x = torch.randn(2, cin, h, h, dtype=dtype)
    w = torch.randn(cout, cin, 4, 4, dtype=dtype)
    return layout(x), layout(w)


REFUSALS = [
    ('fp32', lambda: conv_norm_act(*_conv_args(torch.float32), 1e-5, 'relu',
                                   _nhwc_core='wgmma'), 'not bf16'),
    ('Cin 48', lambda: conv_norm_act(*_conv_args(BF16, cin=48), 1e-5,
                                     'relu', _nhwc_core='wgmma'),
     'channel runs'),
    ('Cout 96', lambda: conv_norm_act(*_conv_args(BF16, cout=96), 1e-5,
                                      'relu', _nhwc_core='wgmma'), 'Cout'),
    ('NCHW x', lambda: conv_norm_act(
        *_conv_args(BF16, layout=lambda t: t), 1e-5, 'relu',
        _nhwc_core='wmma'), 'channels_last'),
    ('unknown core', lambda: conv_norm_act(*_conv_args(BF16), 1e-5, 'relu',
                                           _nhwc_core='mma'), 'one of'),
    ('BN 256', lambda: conv_norm_act(*_conv_args(BF16), 1e-5, 'relu',
                                     _nhwc_core=('wgmma', 256, 4)), 'BN'),
    ('BN 128 of Cout 64', lambda: conv_norm_act(
        *_conv_args(BF16), 1e-5, 'relu', _nhwc_core=('wgmma', 128, 3)),
     'BN'),
    ('5 stages', lambda: conv_norm_act(*_conv_args(BF16), 1e-5, 'relu',
                                       _nhwc_core=('wgmma', 64, 5)), 'BN'),
    ('K3 skip of 6', lambda: convt_norm_act(
        _cl(torch.randn(2, 64, 4, 4, dtype=BF16)),
        _cl(torch.randn(70, 64, 4, 4, dtype=BF16)), 1e-5, 'relu',
        _cl(torch.randn(2, 6, 4, 4, dtype=BF16)), _nhwc_core='wgmma'),
     'channel runs'),
    ('K3 fp32', lambda: convt_norm_act(
        _cl(torch.randn(2, 64, 4, 4)), _cl(torch.randn(64, 64, 4, 4)),
        1e-5, 'relu', _nhwc_core='wgmma'), 'not bf16')]


@pytest.mark.parametrize('label,call,match', REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_nhwc_core_refuses_what_it_cannot_force(label, call, match):
    """``_nhwc_core`` raises ValueError where the core asked for cannot
    take the call, on CPU tensors too, before any plain version runs."""
    with pytest.raises(ValueError, match=match):
        call()


def test_nhwc_core_forced_on_cpu_keeps_the_plain_version():
    """On CPU tensors a core that can take the call changes nothing: the
    plain version's output, through autograd too."""
    x, w = _conv_args(BF16)
    want = conv_norm_act_plain(x, w, 1e-5, 'relu')
    for core in ('wgmma', 'wmma', ('wgmma', 64, 3)):
        assert torch.equal(conv_norm_act(x, w, 1e-5, 'relu',
                                         _nhwc_core=core), want)
    xs, ws = x.float().requires_grad_(), w.float()
    y = convt_norm_act(_cl(torch.randn(2, 64, 4, 4)),
                       _cl(torch.randn(128, 64, 4, 4)), 1e-5, 'relu',
                       _cl(torch.randn(2, 64, 4, 4)), _nhwc_core='wmma')
    assert y.shape == (2, 64, 8, 8)
    conv_norm_act(xs, ws, 1e-5, 'relu', _nhwc_core='wmma').sum().backward()
    assert xs.grad is not None


# the emulation of the wgmma core


def _k2_rows(x, cout):
    """A of K2 over an NHWC x: [N, M, 16 Cin], k = (ky * 4 + kx) Cin + ci,
    output (r, c) reading input (2r - 1 + ky, 2c - 1 + kx)."""
    n, h, w, c = x.shape
    ho, wo = h // 2, w // 2
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, ky:ky + 2 * ho:2, kx:kx + 2 * wo:2, :]
            for ky in range(4) for kx in range(4)]
    return [torch.stack(taps, 3).reshape(n, ho * wo, 16 * c)]


def _k3_rows(xin):
    """A of K3's four classes g = 2 dy + dx over the NHWC concat: [N, M,
    4 C], k = (2 ay + ax) C + ci, class pixel (r, c) reading input (r + dy
    - ay, c + dx - ax)."""
    n, h, w, c = xin.shape
    xp = F.pad(xin, (0, 0, 1, 1, 1, 1))
    out = []
    for g in range(4):
        dy, dx = g >> 1, g & 1
        taps = [xp[:, 1 + dy - ay:1 + dy - ay + h, 1 + dx - ax:1 + dx - ax + w]
                for ay in (0, 1) for ax in (0, 1)]
        out.append(torch.stack(taps, 3).reshape(n, h * w, 4 * c))
    return out


def _reduce_parts(parts):
    """``reduce_parts`` over the last axis of [..., parts, 2]: lane l sums
    partials l, l + 32, ... in order, then an xor butterfly over the 32
    lanes."""
    lanes = torch.zeros(parts.shape[:-2] + (32, 2))
    for i in range(parts.shape[-2]):
        lanes[..., i % 32, :] += parts[..., i, :]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ off, :]
    return lanes[..., 0, :]


def _emulate(a_rows, b, plan, n, m, cout, out_index):
    """The wgmma core's product and statistics: ``a_rows[g]`` [N, M, K],
    ``b[g]`` [Cout, K]; returns (NHWC fp32 output flattened to [N, P,
    Cout] with P the output pixels, stats [N, Cout, 2])."""
    groups = len(a_rows)
    k = a_rows[0].shape[-1]
    steps = k // 64
    per = -(-steps // plan.splits)
    pix = groups * m
    acc = torch.zeros(plan.splits, n, pix, cout)
    part = torch.zeros(n, cout, groups * plan.tiles, 2)
    bands = -(-n // plan.samples) if plan.samples > 1 else n * plan.tiles
    for g in range(groups):
        for bx in range(bands):
            if plan.samples > 1:
                rows = [(bx * plan.samples + r // m, r % m)
                        for r in range(plan.samples * m)
                        if bx * plan.samples + r // m < n]
            else:
                s0, mt = divmod(bx, plan.tiles)
                rows = [(s0, mt * 64 + r) for r in range(64)
                        if mt * 64 + r < m]
            ni = torch.tensor([r[0] for r in rows])
            mi = torch.tensor([r[1] for r in rows])
            for s in range(plan.splits):
                d = torch.zeros(len(rows), cout)
                for ks in range(s * per, min(steps, (s + 1) * per)):
                    sl = slice(64 * ks, 64 * ks + 64)
                    d = d + a_rows[g][ni, mi, sl] @ b[g][:, sl].T
                acc[s, ni, out_index(g, mi)] = d
                if plan.splits > 1:
                    continue
                # partials over each sample's rows, in row order
                for sample in ni.unique():
                    sel = (ni == sample).nonzero().flatten()
                    sums = torch.zeros(cout, 2)
                    for r in sel:
                        sums = sums + torch.stack([d[r], d[r] * d[r]], -1)
                    tile = int(mi[sel[0]]) // 64
                    part[sample, :, g * plan.tiles + tile] = sums
    y = acc[0]
    for s in range(1, plan.splits):
        y = y + acc[s]
    if plan.splits > 1:
        # split_stats: the summed plane's partials over `segs` segments
        segs = nhwc_segments(n, pix, cout, 4)
        seg_len = -(-pix // segs)
        part = torch.stack([torch.stack(
            [y[:, i:i + seg_len].sum(1), (y[:, i:i + seg_len] ** 2).sum(1)],
            -1) for i in range(0, pix, seg_len)], 2)
    return y, _reduce_parts(part)


def _norm_act(y, stats, count, eps, act):
    mean = stats[..., 0] / count
    var = stats[..., 1] / count - mean * mean
    z = (y - mean[:, None]) * torch.rsqrt(var + eps)[:, None]
    return {2: torch.relu, 1: torch.tanh, 3: lambda v: F.leaky_relu(v, 0.2),
            0: lambda v: v}[act_code(act)](z)


def _numpy(shape, seed, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return a * scale


# (split_batch): the launch's own (a K split at these sizes), and one
# large enough that the tiles' partials reduce without a split
SPLIT_BATCHES = [None, 4096]


@pytest.mark.parametrize('split_batch', SPLIT_BATCHES,
                         ids=['split', 'nosplit'])
@pytest.mark.parametrize('h,act', [(16, 'relu'), (4, 'leakyrelu')],
                         ids=['16x16', '4x4-packed'])
def test_emulated_k2_core_matches_pallas(h, act, split_batch):
    """K2 64 -> 64 at batch 4 from 16x16 (M = 64: a tile a sample) and
    from 4x4 (a 2x2 output: 16 samples a tile, 12 slots of padding)."""
    n, cin, cout = 4, 64, 64
    x = _numpy((n, h, h, cin), 1)
    w = _numpy((cout, cin, 4, 4), 2, scale=0.05)
    plan = k2m.conv_nhwc_plan(n, cin, h, h, cout, BF16, True, split_batch)
    assert plan.core == 'wgmma'
    assert plan.samples == (16 if h == 4 else 1)
    assert (plan.splits > 1) == (split_batch is None)
    b = torch.from_numpy(w).permute(0, 2, 3, 1).reshape(cout, 16 * cin)
    m = (h // 2) ** 2
    y, stats = _emulate(_k2_rows(torch.from_numpy(x), cout), [b], plan, n,
                        m, cout, lambda g, mi: mi)
    got = _norm_act(y, stats, m, 1e-5, act).reshape(n, h // 2, h // 2, cout)
    want = fused_conv_norm_act(jnp.asarray(x),
                               jnp.asarray(conv_kernel_to_jax(w)), 1e-5, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize('split_batch', SPLIT_BATCHES,
                         ids=['split', 'nosplit'])
@pytest.mark.parametrize('h,act', [(8, 'relu'), (4, 'tanh')],
                         ids=['8x8', '4x4-packed'])
def test_emulated_k3_core_matches_pallas(h, act, split_batch):
    """K3 (64 + 64) -> 64 at batch 4 from 8x8 (M = 64 a class) and from
    4x4 (M = 16: 4 samples a tile); B from the NHWC pack's layout."""
    n, cx, cs, cout = 4, 64, 64, 64
    x = _numpy((n, h, h, cx), 3)
    s = _numpy((n, h, h, cs), 4)
    w = _numpy((cx + cs, cout, 4, 4), 5, scale=0.05)
    plan = k3m.convt_nhwc_plan(n, cx, cs, h, h, cout, BF16, True,
                               split_batch)
    assert plan.core == 'wgmma'
    assert plan.samples == (4 if h == 4 else 1)
    assert (plan.splits > 1) == (split_batch is None)
    wp = pack_convt_weight_nhwc_plain(torch.from_numpy(w))
    xin = torch.cat([torch.from_numpy(x), torch.from_numpy(s)], -1)

    def out_index(g, mi):   # class pixel -> output pixel of [2H, 2W]
        r, c = mi // h, mi % h
        return (2 * r + (g >> 1)) * 2 * h + 2 * c + (g & 1)

    y, stats = _emulate(_k3_rows(xin), list(wp), plan, n, h * h, cout,
                        out_index)
    got = _norm_act(y, stats, 4 * h * h, 1e-5, act).reshape(
        n, 2 * h, 2 * h, cout)
    want = fused_convt_norm_act(jnp.asarray(x),
                                jnp.asarray(convT_kernel_to_jax(w)), 1e-5,
                                act, jnp.asarray(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)
    # and the port's plain version of the same call
    plain = convt_norm_act_plain(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w), 1e-5,
        act, torch.from_numpy(s).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), plain.permute(0, 2, 3, 1),
                               rtol=1e-3, atol=1e-4)
