"""The band forms of K2 and K3 (spatial parallelism) on the wgmma core, on
the CPU: the host planner at the bands of a 1024-px image, the private
``_core`` argument, the layout pass's plain version and the weights'
orders, and a plain PyTorch emulation of the core's band mode held
against the JAX package's Pallas kernels over the whole image.

In bf16 with channel runs that are multiples of 64, ``pgt_conv_band`` /
``pgt_convt_band`` copy each haloed NCHW band into channels_last scratch
(the layout pass; K2's weight into [Cout, 4, 4, Cin], K3's packed as the
NHWC form packs it), run the wgmma core (``csrc/conv_wgmma.cuh``) with no
padding of H and an NCHW epilogue, and return the band's fp32 output and
its per-plane stats. Here that arithmetic is replayed in the core's order:
tiles of 64 rows packing 64 / M samples where a (sample, class) has M <
64 pixels, K steps of 64 channels of one tap, each K split's share into
its own slice, the slices added in order and the stats taken over the sum
as ``band::split_stats`` takes them (strided thread sums, then a block's
xor butterflies), or without a split the per-(sample, channel) partials in
row order reduced as ``reduce_parts`` reduces them. The bands' stats are
summed, each band is normalised by ``in_apply``'s plain version and the
rows are put back together; in fp32 that must equal the JAX
``fused_conv_norm_act`` / ``fused_convt_norm_act`` of the whole image
(interpret mode on the CPU) within rtol 1e-3 / atol 1e-4.
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
from patchgan_tpu_torch.ops.kernels import (conv_band, conv_band_plain,
                                            convt_band, convt_band_plain,
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
SIZE, BATCH = 1024, 2     # the image and batch of the card's band checks
# the bands checked on the card: (label, sp, rank)
BANDS = (('sp 2 top', 2, 0), ('sp 2 bottom', 2, 1), ('sp 4 middle', 4, 1))

# the nf=64 generator's band levels at SIZE px: K2 enc1-enc6 (Cin, input
# rows and columns, Cout), K3 dec1-dec5 (Cx, Cs, input rows and columns,
# Cout)
K2_LEVELS = [(f'enc{i}', cin, SIZE >> i, cout) for i, (cin, cout) in
             enumerate([(NF, 2 * NF), (2 * NF, 4 * NF), (4 * NF, 8 * NF),
                         (8 * NF, 8 * NF), (8 * NF, 8 * NF),
                         (8 * NF, 8 * NF)], 1)]
K3_LEVELS = [(f'dec{i}', cx, cs, SIZE >> (7 - i), cout)
             for i, cx, cs, cout in
             [(1, 8 * NF, 8 * NF, 8 * NF), (2, 8 * NF, 8 * NF, 8 * NF),
              (3, 8 * NF, 8 * NF, 4 * NF), (4, 4 * NF, 4 * NF, 2 * NF),
              (5, 2 * NF, 2 * NF, NF)]]
CASES = [(kind, label, shape, band) for kind, levels in (
    ('K2', K2_LEVELS), ('K3', K3_LEVELS)) for label, *shape in levels
    for band in BANDS]


def _band_plan(kind, shape, sp, dtype, core=None, split_batch=None,
               n=BATCH):
    """The band entry's plan on a rank's haloed band of ``shape``'s input
    (rows / sp of them, plus two halo rows)."""
    if kind == 'K2':
        cin, h, cout = shape
        return k2m.conv_band_plan(n, cin, h // sp + 2, h, cout, dtype,
                                  split_batch, core)
    cx, cs, h, cout = shape
    return k3m.convt_band_plan(n, cx, cs, h // sp + 2, h, cout, dtype,
                               split_batch, core)


def _band_m(kind, shape, sp):
    """Pixels of one (sample, class) product of a band."""
    h = shape[1] if kind == 'K2' else shape[2]
    return (h // sp // 2) * (h // 2) if kind == 'K2' else (h // sp) * h


@pytest.mark.parametrize('kind,label,shape,band', CASES,
                         ids=[f'{c[1]}-{c[3][0]}' for c in CASES])
def test_band_planner_takes_the_wgmma_core_in_bf16(kind, label, shape,
                                                   band):
    """Every K2 and K3 level of a 1024-px image's bands at batch 2 (a top
    and a bottom band at sp 2, a middle one at sp 4) takes the wgmma core
    in bf16: the block fits, 64 / M samples a tile where a band has M < 64
    pixels a (sample, class) (enc5, enc6 and dec1 at sp 4: 16), and a K
    split that follows split_batch, not the batch."""
    _, sp, _ = band
    plan = _band_plan(kind, shape, sp, BF16)
    m = _band_m(kind, shape, sp)
    cout = shape[-1]
    assert plan.core == 'wgmma'
    assert 0 < plan.smem <= SMEM_PER_BLOCK
    assert plan.bn in (64, 128) and cout % plan.bn == 0
    if m < 64:
        assert plan.samples == 64 // m and plan.tiles == 1
    else:
        assert plan.samples == 1 and plan.tiles == -(-m // 64)
    assert plan.parts == (1 if kind == 'K2' else 4) * plan.tiles
    assert {_band_plan(kind, shape, sp, BF16, split_batch=BATCH,
                       n=n).splits for n in (1, 3, 8)} == {plan.splits}
    steps = (16 * shape[0] if kind == 'K2'
             else 4 * (shape[0] + shape[1])) // 64
    assert plan.splits == 1 or steps // plan.splits >= k2m.WGMMA_MIN_STEPS


@pytest.mark.parametrize('kind,label,shape,band', CASES,
                         ids=[f'{c[1]}-{c[3][0]}' for c in CASES])
def test_band_planner_keeps_fp32_on_the_wmma_core(kind, label, shape,
                                                  band):
    """The same bands in fp32 (17b's gloo step, the fp32 checks) take the
    WMMA core, with choose_splits' split over its 64 x 64 tiles; forcing
    the wgmma core there raises."""
    _, sp, _ = band
    plan = _band_plan(kind, shape, sp, torch.float32)
    assert plan.core == 'wmma' and plan.smem == 0
    assert plan.tiles == -(-_band_m(kind, shape, sp) // 64)
    with pytest.raises(ValueError, match='wgmma core cannot'):
        _band_plan(kind, shape, sp, torch.float32, 'wgmma')


def _k2_band(dtype=BF16, cin=64, cout=64, rows=8, w=8):
    x = torch.randn(2, cin, rows + 2, w).to(dtype)
    return x, torch.randn(cout, cin, 4, 4).to(dtype)


def _k3_band(dtype=BF16, cx=64, cs=64, cout=64, rows=4, w=4):
    x = torch.randn(2, cx, rows + 2, w).to(dtype)
    skip = torch.randn(2, cs, rows + 2, w).to(dtype) if cs else None
    return x, torch.randn(cx + cs, cout, 4, 4).to(dtype), skip


REFUSALS = [
    ('K2 fp32', lambda: conv_band(*_k2_band(torch.float32), _core='wgmma'),
     'not bf16'),
    ('K2 Cin 48', lambda: conv_band(*_k2_band(cin=48), _core='wgmma'),
     'channel runs'),
    ('K2 Cout 96', lambda: conv_band(*_k2_band(cout=96), _core='wgmma'),
     'Cout'),
    ('K2 unknown core', lambda: conv_band(*_k2_band(), _core='mma'),
     'one of'),
    ('K2 BN 128 of Cout 64', lambda: conv_band(*_k2_band(),
                                               _core=('wgmma', 128, 4)),
     'BN'),
    ('K3 fp32', lambda: convt_band(*_k3_band(torch.float32), _core='wgmma'),
     'not bf16'),
    ('K3 skip of 32', lambda: convt_band(*_k3_band(cs=32), _core='wgmma'),
     'channel runs'),
    ('K3 5 stages', lambda: convt_band(*_k3_band(), _core=('wgmma', 64, 5)),
     'BN')]


@pytest.mark.parametrize('label,call,match', REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_band_core_refuses_what_it_cannot_force(label, call, match):
    """``_core`` raises ValueError where the core asked for cannot take the
    band, on CPU tensors too, before the plain version runs."""
    with pytest.raises(ValueError, match=match):
        call()


def test_band_core_forced_on_cpu_keeps_the_plain_version():
    """On CPU tensors a core that can take the band changes nothing: the
    plain version's output and stats."""
    x, w = _k2_band()
    want = conv_band_plain(x, w)
    x3, w3, s3 = _k3_band()
    want3 = convt_band_plain(x3, w3, s3)
    for core in ('wgmma', 'wmma', ('wgmma', 64, 3)):
        for got, ref in ((conv_band(x, w, _core=core), want),
                         (convt_band(x3, w3, s3, _core=core), want3)):
            assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_layout_pass_plain_version_is_the_nchw_input():
    """The layout pass's plain version puts a haloed band's channels last
    (element [n, y, x, c] is the band's [n, c, y, x]) and K2's OIHW weight
    in the wgmma core's [Cout, 4, 4, Cin] order, which is the JAX
    package's HWIO kernel with its output channels first."""
    x = torch.randn(2, 64, 6, 10)
    xt = nchw_to_nhwc_plain(x)
    assert xt.shape == (2, 6, 10, 64) and xt.is_contiguous()
    n, y, c, ch = 1, 4, 7, 33
    assert xt[n, y, c, ch] == x[n, ch, y, c]
    assert torch.equal(xt.permute(0, 3, 1, 2), x)
    w = torch.randn(128, 64, 4, 4)
    wt = nchw_to_nhwc_plain(w)
    assert wt.shape == (128, 4, 4, 64)
    np.testing.assert_array_equal(wt.permute(1, 2, 3, 0).numpy(),
                                  conv_kernel_to_jax(w.numpy()))


def _tap_major_pack(w):
    """``pack_convt_weight<T, TAP_MAJOR>``'s index arithmetic on a CPU
    tensor: thread (co, ci) reads w[ci, co]'s 16 taps and writes, for each
    class g, wp[g, co, (2 ay + ax) C + ci] = tap[(1 - dy + 2 ay) * 4 + 1 -
    dx + 2 ax]."""
    c, cout = w.shape[:2]
    wp = torch.zeros(4, cout, 4 * c)
    taps = w.reshape(c, cout, 16)
    for g in range(4):
        dy, dx = g >> 1, g & 1
        for ay in (0, 1):
            for ax in (0, 1):
                k = (2 * ay + ax) * c
                wp[g, :, k:k + c] = taps[:, :, (1 - dy + 2 * ay) * 4 + 1 -
                                         dx + 2 * ax].T
    return wp


def test_band_pack_writes_the_nhwc_forms_layout():
    """K3's band pack (the NCHW weight read as the NCHW pack reads it,
    written taps outer) gives the NHWC form's packed weight."""
    w = torch.randn(128, 64, 4, 4)
    assert torch.equal(_tap_major_pack(w), pack_convt_weight_nhwc_plain(w))


# the emulation of the wgmma core's band mode


def _k2_band_rows(xt, ho, wo):
    """A of K2 over a channels_last haloed band xt [N, H, W, Cin]: [N, M,
    16 Cin], k = (ky * 4 + kx) Cin + ci, output (r, c) reading band row 2r
    + ky (no row padded) and column 2c - 1 + kx."""
    n, _, _, c = xt.shape
    xp = F.pad(xt, (0, 0, 1, 1))
    taps = [xp[:, ky:ky + 2 * ho:2, kx:kx + 2 * wo:2, :]
            for ky in range(4) for kx in range(4)]
    return [torch.stack(taps, 3).reshape(n, ho * wo, 16 * c)]


def _k3_band_rows(xin):
    """A of K3's classes g = 2 dy + dx over the channels_last haloed
    concat [N, H, W, C]: [N, M, 4 C] with M = (H - 2) W, k = (2 ay + ax) C
    + ci, class pixel (r, c) reading band row r + dy - ay + 1 (a halo row
    where it lands on one) and column c + dx - ax."""
    n, h, w, c = xin.shape
    hc = h - 2
    xp = F.pad(xin, (0, 0, 1, 1))
    out = []
    for g in range(4):
        dy, dx = g >> 1, g & 1
        taps = [xp[:, 1 + dy - ay:1 + dy - ay + hc,
                   1 + dx - ax:1 + dx - ax + w]
                for ay in (0, 1) for ax in (0, 1)]
        out.append(torch.stack(taps, 3).reshape(n, hc * w, 4 * c))
    return out


def _butterfly(lanes):
    """warp_sum2 over the 32 lanes of the second-to-last axis."""
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ off, :]
    return lanes[..., 0, :]


def _reduce_parts(parts):
    """``reduce_parts`` over [..., parts, 2]: lane l sums partials l, l +
    32, ... in order, then an xor butterfly over the 32 lanes."""
    lanes = torch.zeros(parts.shape[:-2] + (32, 2))
    for i in range(parts.shape[-2]):
        lanes[..., i % 32, :] += parts[..., i, :]
    return _butterfly(lanes)


def _split_stats(y):
    """``band::split_stats``'s sums of the summed planes y [..., P]: thread
    t of 256 sums elements t, t + 256, ... in order, then block_sum2 (each
    warp's butterfly, then warp 0's over the 8 warps' sums)."""
    threads = torch.zeros(y.shape[:-1] + (256, 2))
    for i0 in range(0, y.shape[-1], 256):
        v = y[..., i0:i0 + 256]
        threads[..., :v.shape[-1], 0] += v
        threads[..., :v.shape[-1], 1] += v * v
    warps = _butterfly(threads.reshape(y.shape[:-1] + (8, 32, 2)))
    return _butterfly(F.pad(warps, (0, 0, 0, 24)))


def _emulate_band(a_rows, b, plan, n, m, cout, out_index, plane):
    """The wgmma core's band mode: ``a_rows[g]`` [N, M, K], ``b[g]`` [Cout,
    K]; returns (the NCHW fp32 output [N, Cout, plane], stats [N, Cout,
    2])."""
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
                    d = d + a_rows[g][ni, mi, sl] @ b[g][:, sl].T
                acc[s, ni, :, out_index(g, mi)] = d
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
        return y, _split_stats(y)
    return y, _reduce_parts(part)


def _numpy(shape, seed, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return a * scale


def _haloed(x, sp, rank):
    """Rank ``rank``'s band of sp of x [N, C, H, W] with one halo row above
    and below (zero rows at the image's edges)."""
    rows = x.shape[2] // sp
    return F.pad(x, (0, 0, 1, 1))[:, :, rank * rows:(rank + 1) * rows + 2]


# (split_batch): the launch's own (a K split at these sizes), and one
# large enough that the tiles' partials reduce without a split
SPLIT_BATCHES = [None, 4096]
# (image rows and columns, sp, activation)
K2_IMAGES = [(32, 2, 'relu'), (8, 2, 'leakyrelu'), (32, 4, 'tanh')]
K3_IMAGES = [(16, 2, 'relu'), (4, 2, 'tanh'), (16, 4, 'leakyrelu')]


def _recombined(bands, count, act):
    """The bands' (acc, stats) summed over the group, each band normalised
    by in_apply's plain version, the rows put back together."""
    total = sum(st for _, st in bands)
    return torch.cat([in_apply_plain(acc, total, count, 1e-5, act)
                      for acc, _ in bands], dim=2)


@pytest.mark.parametrize('split_batch', SPLIT_BATCHES,
                         ids=['split', 'nosplit'])
@pytest.mark.parametrize('h,sp,act', K2_IMAGES,
                         ids=['32px-sp2', '8px-sp2-packed', '32px-sp4'])
def test_emulated_k2_band_core_matches_pallas(h, sp, act, split_batch):
    """K2 64 -> 64 at batch 2 over the bands of an h x h image: at 32 px
    and sp 2 M = 128 (two tiles a sample), at 8 px M = 8 (8 samples a
    tile), at 32 px and sp 4 M = 64; recombined, the JAX kernel's output
    over the whole image."""
    n, cin, cout = 2, 64, 64
    x = _numpy((n, h, h, cin), 1)
    w = _numpy((cout, cin, 4, 4), 2, scale=0.05)
    xc = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w)
    b = nchw_to_nhwc_plain(wt).reshape(cout, 16 * cin)
    bands = []
    for rank in range(sp):
        xh = _haloed(xc, sp, rank)
        plan = k2m.conv_band_plan(n, cin, xh.shape[2], h, cout, BF16,
                                  split_batch)
        assert plan.core == 'wgmma'
        assert (plan.splits > 1) == (split_batch is None)
        ho, wo = (xh.shape[2] - 4) // 2 + 1, h // 2
        assert plan.samples == max(1, 64 // (ho * wo))
        acc, stats = _emulate_band(
            _k2_band_rows(nchw_to_nhwc_plain(xh), ho, wo), [b], plan, n,
            ho * wo, cout, lambda g, mi: mi, ho * wo)
        acc = acc.reshape(n, cout, ho, wo)
        want_acc, want_stats = conv_band_plain(xh, wt)
        np.testing.assert_allclose(acc.numpy(), want_acc.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(stats.numpy(), want_stats.numpy(),
                                   rtol=1e-4, atol=1e-3)
        bands.append((acc, stats))
    got = _recombined(bands, (h // 2) ** 2, act)
    want = fused_conv_norm_act(jnp.asarray(x),
                               jnp.asarray(conv_kernel_to_jax(w)), 1e-5, act)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize('split_batch', SPLIT_BATCHES,
                         ids=['split', 'nosplit'])
@pytest.mark.parametrize('h,sp,act', K3_IMAGES,
                         ids=['16px-sp2', '4px-sp2-packed', '16px-sp4'])
def test_emulated_k3_band_core_matches_pallas(h, sp, act, split_batch):
    """K3 (64 + 64) -> 64 at batch 2 over the bands of an h x h input: at
    16 px and sp 2 M = 128 a class, at 4 px M = 8 (8 samples a tile), at
    16 px and sp 4 M = 64; the taps that land on a halo row read it; B
    from the NHWC pack's layout; recombined, the JAX kernel's output over
    the whole image."""
    n, cx, cs, cout = 2, 64, 64, 64
    x = _numpy((n, h, h, cx), 3)
    s = _numpy((n, h, h, cs), 4)
    w = _numpy((cx + cs, cout, 4, 4), 5, scale=0.05)
    xc = torch.from_numpy(x).permute(0, 3, 1, 2)
    sc = torch.from_numpy(s).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w)
    wp = pack_convt_weight_nhwc_plain(wt)
    bands = []
    for rank in range(sp):
        xh, sh = _haloed(xc, sp, rank), _haloed(sc, sp, rank)
        hc = xh.shape[2] - 2
        plan = k3m.convt_band_plan(n, cx, cs, xh.shape[2], h, cout, BF16,
                                   split_batch)
        assert plan.core == 'wgmma'
        assert (plan.splits > 1) == (split_batch is None)
        assert plan.samples == max(1, 64 // (hc * h))
        xin = torch.cat([nchw_to_nhwc_plain(xh), nchw_to_nhwc_plain(sh)],
                        -1)

        def out_index(g, mi):   # class pixel -> band output pixel
            r, c = mi // h, mi % h
            return (2 * r + (g >> 1)) * 2 * h + 2 * c + (g & 1)

        acc, stats = _emulate_band(_k3_band_rows(xin), list(wp), plan, n,
                                   hc * h, cout, out_index, 4 * hc * h)
        acc = acc.reshape(n, cout, 2 * hc, 2 * h)
        want_acc, want_stats = convt_band_plain(xh, wt, sh)
        np.testing.assert_allclose(acc.numpy(), want_acc.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(stats.numpy(), want_stats.numpy(),
                                   rtol=1e-4, atol=1e-3)
        bands.append((acc, stats))
    got = _recombined(bands, (2 * h) ** 2, act)
    want = fused_convt_norm_act(jnp.asarray(x),
                                jnp.asarray(convT_kernel_to_jax(w)), 1e-5,
                                act, jnp.asarray(s))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-3, atol=1e-4)
