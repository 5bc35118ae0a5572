"""The NCHW forms of K2 and K3 on the wgmma core, on the CPU: the host
planner at the inference engine's shapes (an 8-tile bucket of 256 px and
one whole 1280x960 image in spatial mode), the private ``_core``
argument, and a plain PyTorch emulation of the route held against the
JAX package's Pallas kernels.

In bf16 with channel runs that are multiples of 64, ``pgt_conv_in_act``
/ ``pgt_convt_in_act`` copy x (and skip) into channels_last scratch (the
layout pass; K2's weight into [Cout, 4, 4, Cin], K3's packed as the NHWC
form packs it), run the wgmma core (``csrc/conv_wgmma.cuh``) on a problem
that pads H as the NHWC form's does and writes NCHW, take the per-plane
stats (``reduce_parts`` over the tiles' partials, or ``band::split_stats``
after a K split) and normalise with ``in_apply``'s kernel over the plane's
own count. Here that arithmetic is replayed in the core's order: tiles of
64 rows packing 64 / M samples where a (sample, class) has M < 64 pixels,
K steps of 64 channels of one tap, each K split's share into its own
slice, the slices added in order. In fp32 it must equal the JAX
``fused_conv_norm_act`` / ``fused_convt_norm_act`` (interpret mode on the
CPU) within rtol 1e-3 / atol 1e-4, and a sample's output must be the same
bits in batches of any size at a fixed split_batch.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_band_wgmma as band_tests
import test_torch_conv_wgmma as nhwc_tests
from patchgan_tpu.ops.pallas.conv_norm_act import fused_conv_norm_act
from patchgan_tpu.ops.pallas.convt_norm_act import fused_convt_norm_act
from patchgan_tpu.utils.transfer import conv_kernel_to_jax, \
    convT_kernel_to_jax
from patchgan_tpu_torch.inference.engine import SPLIT_BATCH
from patchgan_tpu_torch.ops.kernels import (conv_norm_act,
                                            conv_norm_act_plain,
                                            convt_norm_act,
                                            convt_norm_act_plain,
                                            in_apply_plain,
                                            nchw_to_nhwc_plain,
                                            pack_convt_weight_nhwc_plain)

k2m = importlib.import_module('patchgan_tpu_torch.ops.kernels.conv_norm_act')
k3m = importlib.import_module(
    'patchgan_tpu_torch.ops.kernels.convt_norm_act')

torch.set_num_threads(2)
BF16 = torch.bfloat16
NF = 64
SMEM_PER_BLOCK = 232448   # an H100 block's shared memory
# the engine's shape sets: (name, batch, image rows, image columns)
SETS = (('8 tiles', 8, 256, 256), ('image', 1, 1024, 1280))


def _levels(n, h, w):
    """(kind, label, shape) of the nf=64 generator on n images of h x w:
    K2 enc1-enc6 (n, Cin, rows, columns, Cout), K3 dec1-dec5 (n, Cx, Cs,
    rows, columns, Cout)."""
    f = [NF, 2 * NF, 4 * NF, 8 * NF, 8 * NF, 8 * NF, 8 * NF]
    out = [('K2', f'enc{i}', (n, f[i - 1], h >> i, w >> i, f[i]))
           for i in range(1, 7)]
    out += [('K3', f'dec{i}', (n, cx, cs, h >> (7 - i), w >> (7 - i), cout))
            for i, cx, cs, cout in
            [(1, 8 * NF, 8 * NF, 8 * NF), (2, 8 * NF, 8 * NF, 8 * NF),
             (3, 8 * NF, 8 * NF, 4 * NF), (4, 4 * NF, 4 * NF, 2 * NF),
             (5, 2 * NF, 2 * NF, NF)]]
    return out


LEVELS = [(s[0], *lv) for s in SETS for lv in _levels(*s[1:])]


def _plan(kind, shape, dtype=BF16, aligned=True, split_batch=SPLIT_BATCH,
          core=None, n=None):
    """The NCHW form's plan, as ``_forward`` makes it."""
    if kind == 'K2':
        n0, cin, h, w, cout = shape
        return k2m.conv_nhwc_plan(n or n0, cin, h, w, cout, dtype, aligned,
                                  split_batch, core)
    n0, cx, cs, h, w, cout = shape
    return k3m.convt_nhwc_plan(n or n0, cx, cs, h, w, cout, dtype, aligned,
                               split_batch, core)


def _m(kind, shape):
    """Pixels of one (sample, class) product."""
    h, w = shape[-3:-1]
    return (h // 2) * (w // 2) if kind == 'K2' else h * w


@pytest.mark.parametrize('sset,kind,label,shape', LEVELS,
                         ids=[f'{lv[0]}-{lv[2]}' for lv in LEVELS])
def test_nchw_planner_takes_the_wgmma_core_in_bf16(sset, kind, label, shape):
    """Every K2 and K3 level of the engine's 8-tile bucket and of one whole
    1280x960 image in bf16 takes the wgmma core: the block fits, 64 / M
    samples a tile where M < 64, and a K split that follows the engine's
    SPLIT_BATCH whatever the batch (1, 3, 8 or 32 tiles)."""
    plan = _plan(kind, shape)
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
    assert plan.parts == (1 if kind == 'K2' else 4) * plan.tiles
    assert {_plan(kind, shape, n=n) for n in (1, 3, 8, 32)} == {plan}
    steps = (16 * shape[1] if kind == 'K2'
             else 4 * (shape[1] + shape[2])) // 64
    assert plan.splits == 1 or steps // plan.splits >= k2m.WGMMA_MIN_STEPS


def _grid(kind, shape, plan):
    """Blocks of the wgmma launch ``plan`` makes at split_batch ``shape``'s
    batch."""
    rows = -(-shape[0] // plan.samples) if plan.samples > 1 else \
        shape[0] * plan.tiles
    return rows * (1 if kind == 'K2' else 4) * (shape[-1] // plan.bn) * \
        plan.splits


CONFIG_2 = [(kind, label, (16, *shape[:-2], shape[-2], *shape[-2:]))
            for kind, label, shape in nhwc_tests.LEVELS]


@pytest.mark.parametrize('kind,label,shape', CONFIG_2,
                         ids=[c[1] for c in CONFIG_2])
def test_config_2_keeps_its_stages(kind, label, shape):
    """The ring's depth follows the fewest waves (three stages fit three
    blocks an SM at BN 128, four two); at config 2's step shapes that is
    the choice ``tools/conv_nhwc_variants.py --sweep`` set there: three
    stages where the grid has three waves of two blocks an SM (792
    blocks) or more."""
    plan = _plan(kind, shape, split_batch=16)
    assert plan.stages == (3 if _grid(kind, shape, plan) >= 792 else 4)


IMAGE_THREE = {'enc1', 'enc2', 'enc3', 'dec2', 'dec3', 'dec4', 'dec5'}


@pytest.mark.parametrize('kind,label,shape', _levels(1, 1024, 1280),
                         ids=[lv[1] for lv in _levels(1, 1024, 1280)])
def test_image_levels_take_three_stages_where_fewer_waves(kind, label,
                                                          shape):
    """At one whole 1280x960 image the grids of 320 and 640 blocks (K2
    enc2-enc3, K3 dec2-dec3) run in one and two waves at three stages
    against two and three at four, which the card's sweep measured 12-37%
    faster there; the larger grids take three stages as before, the rest
    four."""
    plan = _plan(kind, shape, split_batch=1)
    assert plan.stages == (3 if label in IMAGE_THREE else 4)
    grid = _grid(kind, shape, plan)
    assert k2m.wgmma_waves(grid, plan.bn, plan.stages) <= \
        k2m.wgmma_waves(grid, plan.bn, 7 - plan.stages)


# what keeps the NCHW forms on the WMMA core: (label, kind, shape, dtype,
# aligned)
WMMA_CASES = [
    ('K2 fp32', 'K2', (8, NF, 128, 128, 2 * NF), torch.float32, True),
    ('K3 fp32', 'K3', (8, 2 * NF, 2 * NF, 64, 64, NF), torch.float32, True),
    ('K2 Cout 32', 'K2', (8, NF, 128, 128, 32), BF16, True),
    ('K3 Cout 32', 'K3', (2, 64, 64, 8, 8, 32), BF16, True),
    ('K2 Cin 48', 'K2', (8, 48, 16, 16, NF), BF16, True),
    ('K2 off 16 bytes', 'K2', (8, NF, 128, 128, 2 * NF), BF16, False),
    ('K3 off 16 bytes', 'K3', (1, 8 * NF, 8 * NF, 16, 20, 8 * NF), BF16,
     False)]


@pytest.mark.parametrize('label,kind,shape,dtype,aligned', WMMA_CASES,
                         ids=[c[0] for c in WMMA_CASES])
def test_nchw_planner_keeps_the_rest_on_the_wmma_core(label, kind, shape,
                                                      dtype, aligned):
    """fp32, a tp shard's Cout 32, other channel counts and a pointer off
    16 bytes take the WMMA core with choose_splits' split (the C entry
    point refuses any other); forcing the wgmma core raises."""
    plan = _plan(kind, shape, dtype, aligned)
    assert plan.core == 'wmma' and plan.smem == 0
    assert plan.tiles == -(-_m(kind, shape) // 64)
    with pytest.raises(ValueError, match='wgmma core cannot'):
        _plan(kind, shape, dtype, aligned, core='wgmma')
    assert _plan(kind, shape, dtype, aligned, core='wmma') == plan


def _k2_args(dtype=BF16, cin=64, cout=64, h=8, offset=False):
    x = torch.randn(2 * cin * h * h + 1, dtype=dtype)
    x = x[1:] if offset else x[:-1]
    return x.view(2, cin, h, h), torch.randn(cout, cin, 4, 4, dtype=dtype)


def _k3_args(dtype=BF16, cx=64, cs=64, cout=64, h=4):
    x = torch.randn(2, cx, h, h, dtype=dtype)
    skip = torch.randn(2, cs, h, h, dtype=dtype) if cs else None
    return x, torch.randn(cx + cs, cout, 4, 4, dtype=dtype), skip


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


REFUSALS = [
    ('K2 fp32', lambda: conv_norm_act(*_k2_args(torch.float32), 1e-5,
                                      'relu', _core='wgmma'), 'not bf16'),
    ('K2 Cin 48', lambda: conv_norm_act(*_k2_args(cin=48), 1e-5, 'relu',
                                        _core='wgmma'), 'channel runs'),
    ('K2 Cout 96', lambda: conv_norm_act(*_k2_args(cout=96), 1e-5, 'relu',
                                         _core='wgmma'), 'Cout'),
    ('K2 off 16 bytes', lambda: conv_norm_act(
        *_k2_args(offset=True), 1e-5, 'relu', _core='wgmma'), '16 bytes'),
    ('K2 unknown core', lambda: conv_norm_act(*_k2_args(), 1e-5, 'relu',
                                              _core='mma'), 'one of'),
    ('K2 BN 128 of Cout 64', lambda: conv_norm_act(
        *_k2_args(), 1e-5, 'relu', _core=('wgmma', 128, 4)), 'BN'),
    ('K2 channels_last x', lambda: conv_norm_act(
        *(_cl(t) for t in _k2_args()), 1e-5, 'relu', _core='wmma'),
     '_nhwc_core'),
    ('K3 fp32', lambda: convt_norm_act(
        *_k3_args(torch.float32)[:2], 1e-5, 'relu',
        _k3_args(torch.float32)[2], _core='wgmma'), 'not bf16'),
    ('K3 skip of 32', lambda: convt_norm_act(
        *_k3_args(cs=32)[:2], 1e-5, 'relu', _k3_args(cs=32)[2],
        _core='wgmma'), 'channel runs'),
    ('K3 Cout 32', lambda: convt_norm_act(
        *_k3_args(cout=32)[:2], 1e-5, 'relu', _k3_args(cout=32)[2],
        _core='wgmma'), 'Cout'),
    ('K3 5 stages', lambda: convt_norm_act(
        *_k3_args()[:2], 1e-5, 'relu', _k3_args()[2],
        _core=('wgmma', 64, 5)), 'BN'),
    ('K3 channels_last x', lambda: convt_norm_act(
        *(_cl(t) for t in _k3_args()[:2]), 1e-5, 'relu',
        _cl(_k3_args()[2]), _core='wgmma'), '_nhwc_core')]


@pytest.mark.parametrize('label,call,match', REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_nchw_core_refuses_what_it_cannot_force(label, call, match):
    """``_core`` raises ValueError where the core asked for cannot take the
    call, or where x is channels_last (the NHWC form's ``_nhwc_core``
    forces that one), on CPU tensors too, before the plain version
    runs."""
    with pytest.raises(ValueError, match=match):
        call()


def test_nchw_core_forced_on_cpu_keeps_the_plain_version():
    """On CPU tensors a core that can take the call changes nothing: the
    plain version's output, through autograd too."""
    x, w = _k2_args()
    want = conv_norm_act_plain(x, w, 1e-5, 'relu')
    x3, w3, s3 = _k3_args()
    want3 = convt_norm_act_plain(x3, w3, 1e-5, 'tanh', s3)
    for core in ('wgmma', 'wmma', ('wgmma', 64, 3)):
        assert torch.equal(conv_norm_act(x, w, 1e-5, 'relu', _core=core),
                           want)
        assert torch.equal(convt_norm_act(x3, w3, 1e-5, 'tanh', s3,
                                          _core=core), want3)
    xs = x.float().requires_grad_()
    conv_norm_act(xs, w.float(), 1e-5, 'relu', _core='wmma').sum().backward()
    assert xs.grad is not None and xs.grad.shape == x.shape


# the emulation of the NCHW route on the wgmma core


def _emulate(a_rows, b, plan, n, m, cout, out_index, plane):
    """The wgmma core's product of an NCHW problem and its stats:
    ``a_rows[g]`` [N, M, K] from the channels_last copies with H padded,
    ``b[g]`` [Cout, K]; returns (the NCHW fp32 output [N, Cout, plane],
    stats [N, Cout, 2]). Each row's K step is a sum of its own products,
    whatever rows share its tile, so a row's bits depend on its sample
    alone."""
    groups = len(a_rows)
    steps = a_rows[0].shape[-1] // 64
    per = -(-steps // plan.splits)
    acc = torch.zeros(plan.splits, n, cout, plane)
    part = torch.zeros(n, cout, groups * plan.tiles, 2)
    tiles = -(-n // plan.samples) if plan.samples > 1 else n * plan.tiles
    for g in range(groups):
        for bx in range(tiles):
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
                    d = d + (a_rows[g][ni, mi, sl][:, None, :] *
                             b[g][None, :, sl]).sum(-1)
                acc[s, ni, :, out_index(g, mi)] = d
                if plan.splits > 1:
                    continue
                # partials over each sample's rows, in row order
                for sample in ni.unique():
                    sel = (ni == sample).nonzero().flatten()
                    sums = torch.zeros(cout, 2)
                    for r in sel:
                        sums = sums + torch.stack([d[r], d[r] * d[r]], -1)
                    part[sample, :, g * plan.tiles + int(mi[sel[0]]) // 64] \
                        = sums
    y = acc[0]
    for s in range(1, plan.splits):
        y = y + acc[s]
    if plan.splits > 1:
        return y, band_tests._split_stats(y)
    return y, band_tests._reduce_parts(part)


def _k2_route(x, w, act, split_batch):
    """K2's NCHW route on x (N, Cin, H, W): the layout pass, the core's
    product and stats, the apply over the plane's count. Returns (the
    NCHW output, the plan)."""
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    plan = k2m.conv_nhwc_plan(n, cin, h, wd, cout, BF16, True, split_batch)
    assert plan.core == 'wgmma'
    b = nchw_to_nhwc_plain(w).reshape(cout, 16 * cin)
    ho, wo = h // 2, wd // 2
    acc, stats = _emulate(nhwc_tests._k2_rows(nchw_to_nhwc_plain(x), cout),
                          [b], plan, n, ho * wo, cout, lambda g, mi: mi,
                          ho * wo)
    y = in_apply_plain(acc.reshape(n, cout, ho, wo), stats, ho * wo, 1e-5,
                       act)
    return y, plan


def _k3_route(x, skip, w, act, split_batch):
    """K3's NCHW route on x and skip (N, C, H, W): the layout passes, the
    NHWC form's pack, the core's product and stats, the apply. Returns
    (the NCHW output, the plan)."""
    n, cx, h, wd = x.shape
    cs, cout = skip.shape[1], w.shape[1]
    plan = k3m.convt_nhwc_plan(n, cx, cs, h, wd, cout, BF16, True,
                               split_batch)
    assert plan.core == 'wgmma'
    xin = torch.cat([nchw_to_nhwc_plain(x), nchw_to_nhwc_plain(skip)], -1)

    def out_index(g, mi):   # class pixel -> output pixel of [2H, 2W]
        r, c = mi // wd, mi % wd
        return (2 * r + (g >> 1)) * 2 * wd + 2 * c + (g & 1)

    acc, stats = _emulate(nhwc_tests._k3_rows(xin),
                          list(pack_convt_weight_nhwc_plain(w)), plan, n,
                          h * wd, cout, out_index, 4 * h * wd)
    y = in_apply_plain(acc.reshape(n, cout, 2 * h, 2 * wd), stats,
                       4 * h * wd, 1e-5, act)
    return y, plan


def _numpy(shape, seed, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return a * scale


BATCH = 3
# split_batch: one tile's, the engine's, the launch's own, and one large
# enough that the tiles' partials reduce without a split
SPLIT_BATCHES = [1, SPLIT_BATCH, None, 4096]
SPLIT_IDS = ['1', 'engine', 'N', 'nosplit']


@pytest.mark.parametrize('split_batch', SPLIT_BATCHES, ids=SPLIT_IDS)
@pytest.mark.parametrize('h,act', [(16, 'relu'), (4, 'leakyrelu')],
                         ids=['16x16', '4x4-packed'])
def test_emulated_k2_nchw_route_matches_pallas(h, act, split_batch):
    """K2 64 -> 64 at batch 3 from NCHW x: from 16x16 (M = 64: a tile a
    sample) and from 4x4 (a 2x2 output: 16 samples a tile, 13 slots of
    padding); the image's edge rows read as zero, as the padded problem
    zero-fills them."""
    cin, cout = 64, 64
    x = _numpy((BATCH, h, h, cin), 1)
    w = _numpy((cout, cin, 4, 4), 2, scale=0.05)
    got, plan = _k2_route(torch.from_numpy(x).permute(0, 3, 1, 2)
                          .contiguous(), torch.from_numpy(w), act,
                          split_batch or BATCH)
    assert plan.samples == (16 if h == 4 else 1)
    assert (plan.splits == 1) == (split_batch == 4096)
    want = fused_conv_norm_act(jnp.asarray(x),
                               jnp.asarray(conv_kernel_to_jax(w)), 1e-5, act)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize('split_batch', SPLIT_BATCHES, ids=SPLIT_IDS)
@pytest.mark.parametrize('h,w,act', [(8, 8, 'relu'), (4, 4, 'tanh'),
                                     (4, 6, None)],
                         ids=['8x8', '4x4-packed', '4x6'])
def test_emulated_k3_nchw_route_matches_pallas(h, w, act, split_batch):
    """K3 (64 + 64) -> 64 at batch 3 from NCHW x and skip: from 8x8 (M =
    64 a class), 4x4 (M = 16: 4 samples a tile) and 4x6 (M = 24: 2
    samples, H != W); B from the NHWC pack's layout."""
    cx, cs, cout = 64, 64, 64
    x = _numpy((BATCH, h, w, cx), 3)
    s = _numpy((BATCH, h, w, cs), 4)
    wt = _numpy((cx + cs, cout, 4, 4), 5, scale=0.05)
    got, plan = _k3_route(torch.from_numpy(x).permute(0, 3, 1, 2),
                          torch.from_numpy(s).permute(0, 3, 1, 2),
                          torch.from_numpy(wt), act, split_batch or BATCH)
    assert plan.samples == max(1, 64 // (h * w))
    assert (plan.splits == 1) == (split_batch == 4096)
    want = fused_convt_norm_act(jnp.asarray(x),
                                jnp.asarray(convT_kernel_to_jax(wt)), 1e-5,
                                act, jnp.asarray(s))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-3, atol=1e-4)
    plain = convt_norm_act_plain(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(wt), 1e-5,
        act, torch.from_numpy(s).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize('kind,h', [('K2', 16), ('K2', 4), ('K3', 8),
                                    ('K3', 4)],
                         ids=['K2-16x16', 'K2-4x4-packed', 'K3-8x8',
                              'K3-4x4-packed'])
def test_emulated_sample_is_the_same_bits_in_any_batch(kind, h):
    """At the engine's split_batch a sample's emulated output is the same
    bits alone, in a batch of 3 and in one of 8 (the plan, the K split and
    the sample's slot in a packed tile do not change with the batch)."""
    torch.manual_seed(7)
    x = torch.randn(8, 64, h, h)
    outs = []
    if kind == 'K2':
        w = torch.randn(64, 64, 4, 4) * 0.05
        for n in (1, 3, 8):
            outs.append(_k2_route(x[:n], w, 'relu', SPLIT_BATCH))
    else:
        s = torch.randn(8, 64, h, h)
        w = torch.randn(128, 64, 4, 4) * 0.05
        for n in (1, 3, 8):
            outs.append(_k3_route(x[:n], s[:n], w, 'relu', SPLIT_BATCH))
    assert len({plan for _, plan in outs}) == 1
    one, three, eight = (y for y, _ in outs)
    assert torch.equal(one[0], three[0]) and torch.equal(one[0], eight[0])
    assert torch.equal(three, eight[:3])


class _Lib:
    """Stands in for a ctypes library: records each entry's argtypes."""

    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, type('Entry', (), {})())


C_TYPES = {'void*': 'c_void_p', 'int': 'c_int', 'long': 'c_long',
           'float': 'c_float'}


def _c_entries(source):
    """{name: [the ctypes type of each parameter]} of the extern "C"
    functions of csrc/``source``.cu and the headers it may include."""
    import ctypes
    import os
    import re
    csrc = os.path.join(os.path.dirname(k2m.__file__), '..', '..', 'csrc')
    text = ''
    for name in sorted(os.listdir(csrc)):
        if name == f'{source}.cu' or name.endswith('.cuh'):
            with open(os.path.join(csrc, name)) as f:
                text += f.read()
    out = {}
    for name, params in re.findall(r'extern "C" \w+\s+(\w+)\(([^)]*)\)',
                                   text):
        kinds = []
        for p in params.split(','):
            p = ' '.join(p.replace('const ', '').split())
            if not p or p == 'void':
                continue
            ctype = p.rsplit(' ', 1)[0].replace(' *', '*')
            if p.split()[-1].startswith('*'):
                ctype += '*'
            kinds.append(getattr(ctypes, C_TYPES[ctype]))
        out[name] = kinds
    return out


@pytest.mark.parametrize('module,source', [(k2m, 'conv_norm_act'),
                                           (k3m, 'convt_norm_act')],
                         ids=['K2', 'K3'])
def test_ctypes_entries_match_their_c_declarations(monkeypatch, module,
                                                   source):
    """Each argtypes list the wrapper gives its library names the C entry
    point's parameters in order (a mismatch shows only as a TypeError or
    a wrong launch on the card)."""
    lib = _Lib()
    monkeypatch.setattr(module._build, 'load', lambda name: lib)
    module._lib.__wrapped__()
    declared = _c_entries(source)
    assert 'pgt_conv_in_act' in declared or 'pgt_convt_in_act' in declared
    for name, entry in lib.entries.items():
        assert name in declared, name
        assert list(entry.argtypes) == declared[name], name
