"""The band forms of K1-bwd's two halves (``in_bwd_sums``, ``in_bwd_apply``)
on the CPU: their host planners at the bands the card runs, and plain
emulations of their kernels' orders held against the JAX package's
Pallas K1-bwd over the whole image.

On the card (``csrc/band_norm.cuh``) a band's sums take one of two
kernels. A plane of at most 1024 chunks (16 bytes each, or one element on
the element path) goes to a group of threads sized by ``plane_geometry``:
lane l adds chunks l, l + group, ... in order, then the group's xor
butterflies (or, above 32 lanes, each warp's butterflies and the warps in
order). A larger plane is split over ``cluster`` CTAs of 256 threads, each
over a contiguous segment of ``seg`` chunks: thread t adds chunks
lo + t + m * 256 in order of m, a CTA reduces as ``block_sum2`` does (each
warp's butterflies, then warp 0's over the warps' sums) and the CTAs' pairs
are added in rank order. dx walks the band's planes as one range of the
same chunks; a thread keeps track of its chunks' planes by adding. Here
the planners must cover every element of every plane exactly once, with
no chunk across a plane,
at 17a's bands of a 1024-px image (``chip_smoke.py``) and at phase 15's
spatial bands of the 1280x960 and 4096x4096 images; and the emulated
sums of 2 and 3 bands, added in band order, and each band's dx in the
emulated walk must give the JAX vjp of ``instance_norm_act_pallas``
(interpret mode) in fp32 within rtol 1e-3 / atol 1e-4, in every
activation.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchgan_tpu.ops.pallas.norm_act import instance_norm_act_pallas
from patchgan_tpu_torch.models.unet import gather_level
from patchgan_tpu_torch.ops.kernels import (in_apply_plain, in_bwd_apply,
                                            in_bwd_apply_plain, in_bwd_sums,
                                            in_bwd_sums_plain, in_stats,
                                            in_stats_plain)

na = importlib.import_module('patchgan_tpu_torch.ops.kernels.norm_act')

torch.set_num_threads(2)
ACTS = [None, 'tanh', 'relu', 'leakyrelu']
THREADS = na.BAND_THREADS
NF = 64
FILTS = [NF, 2 * NF, 4 * NF, 8 * NF, 8 * NF, 8 * NF, 8 * NF]
DEC_C = [8 * NF, 8 * NF, 4 * NF, 2 * NF, NF]      # dec1-dec5's outputs


def band_shapes(n, h, w, k):
    """(label, band (N, C, rows, W)) of every normed level a rank runs on a
    band when an (h, w) image at batch n is split by rows over k ranks
    (the levels above ``gather_level``)."""
    top = gather_level(h, k)
    out = []
    for i in range(top):
        out.append((f'enc{i}', (n, FILTS[i], (h >> (i + 1)) // k,
                                w >> (i + 1))))
    for lvl in range(1, 6):
        enc = 5 - lvl               # the encoder level of the same rows
        if enc < top:
            out.append((f'dec{lvl}', (n, DEC_C[lvl - 1],
                                      (h >> (enc + 1)) // k, w >> (enc + 1))))
    return out


# 17a's bands (batch 2, 1024 px: the sp-2 top and bottom bands share a
# shape, the sp-4 middle one), phase 15's spatial bands (batch 1: the
# 1280x960 image padded to 1024 x 1280, and 4096 x 4096, over 2 and 4
# cards)
BAND_SETS = {'17a sp 2': band_shapes(2, 1024, 1024, 2),
             '17a sp 4 middle': band_shapes(2, 1024, 1024, 4),
             '1280x960 over 2': band_shapes(1, 1024, 1280, 2),
             '1280x960 over 4': band_shapes(1, 1024, 1280, 4),
             '4096 over 2': band_shapes(1, 4096, 4096, 2),
             '4096 over 4': band_shapes(1, 4096, 4096, 4)}
CASES = [(name, label, shape) for name, shapes in BAND_SETS.items()
         for label, shape in shapes]
SMALL = 1 << 22     # the element path's dx walk is emulated up to this


def _id(case):
    name, label, shape = case
    return f'{name}-{label}-{"x".join(map(str, shape))}'


def sums_cover(plan, planes, plane, esize):
    """The chunks each thread of ``plan`` adds, as csrc/band_norm.cuh's
    loops take them: every chunk of a plane added once, every plane owned
    by one group or by ``cluster`` CTAs of distinct ranks, no chunk across
    a plane. Returns the plane's chunk count."""
    width = 16 // esize if plan.vec else 1
    chunks = plane // width
    assert chunks * width == plane, 'a chunk crosses a plane'
    seen = np.zeros(chunks, np.int64)
    if plan.cluster == 0:
        assert plan.per_thread in (1, 4)
        lanes = np.arange(plan.group)
        for k in range(plan.per_thread):
            i = k * plan.group + lanes
            np.add.at(seen, i[i < chunks], 1)
        i = plan.per_thread * plan.group + lanes
        while (i < chunks).any():
            np.add.at(seen, i[i < chunks], 1)
            i = i + plan.group
        per_block = plan.threads // plan.group
        owners = np.arange(plan.grid * per_block)
        assert np.array_equal(owners[owners < planes], np.arange(planes))
        assert plan.grid == -(-planes // per_block)
    else:
        assert plan.cluster in (1, 2, 4, 8)
        assert plan.seg == -(-chunks // plan.cluster)
        assert plan.grid == planes * plan.cluster
        t = np.arange(THREADS)
        for rank in range(plan.cluster):
            lo = rank * plan.seg
            hi = min(lo + plan.seg, chunks)
            i = lo + t
            while (i < hi).any():
                for k in range(na.BAND_UNROLL):
                    j = i + k * THREADS
                    np.add.at(seen, j[j < hi], 1)
                i = i + THREADS * na.BAND_UNROLL
    assert (seen == 1).all()
    return chunks


def apply_walk(plan, planes, plane):
    """The plane of every chunk of ``plan``'s range as the kernel's
    threads track it (one division at a thread's start, then adding), and
    how often each chunk is written: (planes [n], counts [n])."""
    per = plane // plan.width
    assert per * plan.width == plane, 'a chunk crosses a plane'
    n = planes * per
    span = THREADS * plan.unroll
    jump = plan.grid * span
    dq, dr = divmod(THREADS, per)
    jq, jr = divmod(jump, per)
    v = (np.arange(plan.grid)[:, None] * span
         + np.arange(THREADS)[None, :]).ravel()
    v = v[v < n]
    wp, wr = v // per, v % per
    owner = np.full(n, -1, np.int32)
    counts = np.zeros(n, np.uint8)

    def step(p, r, q, d):
        p, r = p + q, r + d
        over = r >= per
        return p + over, r - per * over

    while v.size:
        up, ur = wp, wr
        for k in range(na.BAND_UNROLL):
            i = v + k * THREADS
            sel = (i < n) & (k < plan.unroll)
            owner[i[sel]] = up[sel]
            counts[i[sel]] += 1
            up, ur = step(up, ur, dq, dr)
        wp, wr = step(wp, wr, jq, jr)
        v = v + jump
        keep = v < n
        v, wp, wr = v[keep], wp[keep], wr[keep]
    return owner, counts


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'fp32'])
@pytest.mark.parametrize('case', CASES, ids=_id)
def test_band_sums_plan_covers_each_chunk_once(case, dtype):
    """``band_sums_plan`` at a band the card runs, aligned and one element
    off 16 bytes: every element of every plane added once; a plane of at
    most 1024 chunks on a group (plane_geometry's), a larger one split
    over a cluster of at most 8; the vector path exactly where the
    plane's bytes are a multiple of 16."""
    _, _, (n, c, h, w) = case
    planes, plane, esize = n * c, h * w, dtype.itemsize
    for aligned in (True, False):
        plan = na.band_sums_plan(planes, plane, dtype, aligned)
        assert plan.vec == (aligned and plane * esize % 16 == 0)
        chunks = sums_cover(plan, planes, plane, esize)
        small = chunks <= THREADS * na.BAND_UNROLL
        assert (plan.cluster == 0) == small
        if not small:
            assert plan.cluster <= na.CLUSTER_MAX
            # each CTA keeps BAND_UNROLL chunks a thread in flight
            assert plan.seg >= THREADS * na.BAND_UNROLL


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'fp32'])
@pytest.mark.parametrize('case', CASES, ids=_id)
def test_band_bwd_apply_plan_covers_each_element_once(case, dtype):
    """``band_bwd_apply_plan``'s walk at a band the card runs: every
    chunk written once, each within one plane and with that plane's stats
    and sums; the element path (one element off 16 bytes) where the range
    is small enough to walk here."""
    _, _, (n, c, h, w) = case
    planes, plane = n * c, h * w
    for aligned in (True, False):
        plan = na.band_bwd_apply_plan(planes, plane, dtype, aligned)
        assert plan.vec == (aligned and plane * dtype.itemsize % 16 == 0)
        assert plan.unroll in (1, 2, 4)
        assert plan.grid <= na.DX_BLOCKS_MAX
        if not aligned and planes * plane > SMALL:
            continue
        owner, counts = apply_walk(plan, planes, plane)
        assert (counts == 1).all()
        assert (owner.reshape(planes, -1)
                == np.arange(planes, dtype=np.int32)[:, None]).all()


@pytest.mark.parametrize('planes,plane', [(6, 15), (4, 8643), (5, 3),
                                          (3, 1 << 21), (1024, 32)])
def test_band_plans_odd_planes(planes, plane):
    """Planes whose bytes are no multiple of 16 (element by element), a
    plane of 2 M elements (a cluster of 8), and 32-element planes: both
    planners cover each element once."""
    for dtype in (torch.bfloat16, torch.float32):
        plan = na.band_sums_plan(planes, plane, dtype)
        sums_cover(plan, planes, plane, dtype.itemsize)
        if plane == 1 << 21:
            assert plan.cluster == na.CLUSTER_MAX
        plan = na.band_bwd_apply_plan(planes, plane, dtype)
        assert plan.vec == (plane * dtype.itemsize % 16 == 0)
        owner, counts = apply_walk(plan, planes, plane)
        assert (counts == 1).all()


def test_band_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors ``in_bwd_sums`` and ``in_bwd_apply`` are their plain
    versions."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 3, 4, 8)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 3, 4, 8)).astype(np.float32))
    st = in_stats_plain(x) * 2
    u = in_bwd_sums(g, x, st, 64, 1e-5, 'relu')
    assert torch.equal(u, in_bwd_sums_plain(g, x, st, 64, 1e-5, 'relu'))
    assert torch.equal(in_bwd_apply(g, x, st, u, 64, 1e-5, 'tanh'),
                       in_bwd_apply_plain(g, x, st, u, 64, 1e-5, 'tanh'))


# the kernels' arithmetic, emulated in fp32


def _mean_rstd(st, count, eps):
    """band::mean_rstd per plane [planes], fp32."""
    mean = st[:, 0] / count
    var = st[:, 1] / count - mean * mean
    return mean, torch.rsqrt(var + eps)


def _butterfly(v, lanes):
    """xor butterflies over the last axis's ``lanes`` lanes (offsets
    lanes / 2 ... 1), as __shfl_xor_sync; every lane ends with the sum."""
    o = lanes // 2
    idx = torch.arange(lanes)
    while o:
        v = v + v[..., idx ^ o]
        o //= 2
    return v


def _thread_sums(terms):
    """A thread's own sum of terms [..., m, W] in order of m, then of the
    chunk's W elements."""
    s = torch.zeros(terms.shape[:-2])
    for m in range(terms.shape[-2]):
        for j in range(terms.shape[-1]):
            s = s + terms[..., m, j]
    return s


def _card_order(t, plan):
    """Each plane's sum of terms t [planes, chunks, width] in the order of
    the card's kernels under ``plan`` (band_norm.cuh's group or cluster
    kernel), fp32: [planes]."""
    planes, chunks, width = t.shape
    if plan.cluster == 0:
        group = plan.group
        m = -(-chunks // group)
        t = torch.nn.functional.pad(t, (0, 0, 0, m * group - chunks))
        s = _thread_sums(t.reshape(planes, m, group, width)
                         .permute(0, 2, 1, 3))        # [planes, group]
        if group <= 32:
            return _butterfly(s, group)[:, 0]
        warps = _butterfly(s.reshape(planes, group // 32, 32), 32)[..., 0]
        total = torch.zeros(planes)
        for i in range(group // 32):
            total = total + warps[:, i]
        return total
    k, seg = plan.cluster, plan.seg
    m = -(-seg // THREADS)
    t = torch.nn.functional.pad(t, (0, 0, 0, k * seg - chunks))
    t = t.reshape(planes, k, seg, width)
    t = torch.nn.functional.pad(t, (0, 0, 0, m * THREADS - seg))
    s = _thread_sums(t.reshape(planes, k, m, THREADS, width)
                     .permute(0, 1, 3, 2, 4))   # [planes, k, THREADS]
    warps = _butterfly(s.reshape(planes, k, THREADS // 32, 32), 32)[..., 0]
    warps = torch.nn.functional.pad(warps, (0, 32 - THREADS // 32))
    cta = _butterfly(warps, 32)[..., 0]           # [planes, k]
    total = torch.zeros(planes)
    for r in range(k):
        total = total + cta[:, r]
    return total


def emulate_sums(g, x, st, count, eps, act, plan):
    """``in_bwd_sums`` in the card's order under ``plan`` (fp32): [N, C,
    2]."""
    n, c, h, w = x.shape
    planes, plane = n * c, h * w
    mean, rstd = _mean_rstd(st.reshape(planes, 2), count, eps)
    xh = (x.float().reshape(planes, plane) - mean[:, None]) * rstd[:, None]
    gm = g.float().reshape(planes, plane) * na.act_grad(xh, act)
    width = 16 // x.element_size() if plan.vec else 1
    out = [_card_order(t.reshape(planes, plane // width, width), plan)
           for t in (gm, gm * xh)]
    return torch.stack(out, dim=-1).reshape(n, c, 2)


def emulate_stats(x, plan):
    """``in_stats`` in the card's order under ``plan`` (fp32): the same
    kernels as ``in_bwd_sums``, each element adding (v, v^2). [N, C,
    2]."""
    n, c, h, w = x.shape
    planes, plane = n * c, h * w
    v = x.float().reshape(planes, plane)
    width = 16 // x.element_size() if plan.vec else 1
    out = [_card_order(t.reshape(planes, plane // width, width), plan)
           for t in (v, v * v)]
    return torch.stack(out, dim=-1).reshape(n, c, 2)


def emulate_bwd_apply(g, x, st, sums, count, eps, act, plan):
    """``in_bwd_apply`` under ``plan``: each chunk's dx from the stats
    and sums of the plane the kernel's walk gives it."""
    n, c, h, w = x.shape
    planes, plane = n * c, h * w
    owner, counts = apply_walk(plan, planes, plane)
    assert (counts == 1).all()
    owner = torch.from_numpy(owner).long()
    mean, rstd = _mean_rstd(st.reshape(planes, 2), count, eps)
    m1 = sums.reshape(planes, 2)[:, 0] / count
    m2 = sums.reshape(planes, 2)[:, 1] / count
    r = rstd[owner][:, None]
    xh = (x.float().reshape(-1, plan.width) - mean[owner][:, None]) * r
    gm = g.float().reshape(-1, plan.width) * na.act_grad(xh, act)
    dx = r * (gm - m1[owner][:, None] - xh * m2[owner][:, None])
    return dx.to(g.dtype).reshape(x.shape)


def _bands(t, k):
    rows = t.shape[2] // k
    return [t[:, :, r * rows:(r + 1) * rows].contiguous() for r in range(k)]


def _nhwc(t):
    return np.transpose(t.float().numpy(), (0, 2, 3, 1))


def _close(got, want):
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32),
                               rtol=1e-3, atol=1e-4)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 2.0 + 0.5
    g = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(g)


def _forced(plan, cluster, planes, plane, esize):
    """``plan`` with each plane split over ``cluster`` CTAs instead."""
    chunks = plane // (16 // esize if plan.vec else 1)
    return na.BandSums(plan.vec, THREADS, na.BAND_UNROLL, THREADS, cluster,
                       -(-chunks // cluster), planes * cluster)


# (whole image (N, C, H, W), bands, the plan's cluster: None the
# planner's, else forced): group kinds (8 x 16 and 4 x 24 bands: lanes;
# 32 x 64: a block), the cluster kind at 1-8 CTAs a plane (64 x 128 and
# 96 x 128 bands, 2048 and 3072 fp32 chunks; element by element, 8192 and
# 12288)
SUM_CASES = [((2, 3, 16, 16), 2, None), ((1, 4, 12, 24), 3, None),
             ((1, 2, 64, 64), 2, None),
             ((1, 2, 128, 128), 2, None), ((1, 2, 192, 128), 3, None),
             ((1, 2, 128, 128), 2, 1), ((1, 2, 128, 128), 2, 4),
             ((1, 2, 192, 128), 2, 8)]


@pytest.mark.parametrize('aligned', [True, False], ids=['vec', 'element'])
@pytest.mark.parametrize('shape,k,cluster', SUM_CASES,
                         ids=lambda v: str(v).replace(' ', ''))
def test_band_sums_order_recombined_matches_pallas_vjp(shape, k, cluster,
                                                      aligned):
    """fp32: each band's sums in the card's order (emulated under its
    plan) within 1e-5 of max(1, max |sum|) of the plain sums; the bands'
    sums added in band order, each band's dx by ``in_bwd_apply_plain``
    and the rows put back together: the JAX vjp of
    ``instance_norm_act_pallas`` (interpret mode) within rtol 1e-3 / atol
    1e-4."""
    x, g = _inputs(shape, 40 + k)
    st = in_stats_plain(x)
    count = shape[2] * shape[3]
    xs, gs = _bands(x, k), _bands(g, k)
    total = 0
    for xb, gb in zip(xs, gs):
        planes, plane = xb.shape[0] * xb.shape[1], xb.shape[2] * xb.shape[3]
        plan = na.band_sums_plan(planes, plane, xb.dtype, aligned)
        if cluster:
            plan = _forced(plan, cluster, planes, plane, xb.element_size())
        sums_cover(plan, planes, plane, xb.element_size())
        u = emulate_sums(gb, xb, st, count, 1e-5, 'relu', plan)
        want = in_bwd_sums_plain(gb, xb, st, count, 1e-5, 'relu')
        assert (u - want).abs().max() <= 1e-5 * max(1.0, want.abs().max())
        total = total + u
    dx = torch.cat([in_bwd_apply_plain(gb, xb, st, total, count, 1e-5,
                                       'relu')
                    for xb, gb in zip(xs, gs)], dim=2)
    _, vjp = jax.vjp(lambda a: instance_norm_act_pallas(a, 1e-5, 'relu'),
                     jnp.asarray(_nhwc(x)))
    want, = vjp(jnp.asarray(_nhwc(g)))
    _close(dx, want)


@pytest.mark.parametrize('act', ACTS)
@pytest.mark.parametrize('shape,k', [((2, 3, 16, 24), 2),
                                     ((1, 2, 144, 96), 3),
                                     ((2, 2, 12, 5), 2)],
                         ids=['16x24-2', '144x96-3', '12x5-2'])
def test_band_bwd_recombined_matches_pallas_vjp(shape, k, act):
    """fp32, every activation: each band's sums in the card's order
    (emulated under ``band_sums_plan``; a group at 16 x 24, a cluster at
    144 x 96 over 3), added in band order, each band's dx in the card's
    walk (emulated under ``band_bwd_apply_plan``; 12 x 5 goes element by
    element), the rows put back together: the JAX vjp of
    ``instance_norm_act_pallas`` (interpret mode) within rtol 1e-3 / atol
    1e-4; the emulated dx equal to ``in_bwd_apply_plain``'s."""
    x, g = _inputs(shape, 60 + k)
    st = in_stats_plain(x)
    count = shape[2] * shape[3]
    xs, gs = _bands(x, k), _bands(g, k)
    total = 0
    for xb, gb in zip(xs, gs):
        plan = na.band_sums_plan(xb.shape[0] * xb.shape[1],
                                 xb.shape[2] * xb.shape[3], xb.dtype)
        total = total + emulate_sums(gb, xb, st, count, 1e-5, act, plan)
    parts = []
    for xb, gb in zip(xs, gs):
        plan = na.band_bwd_apply_plan(xb.shape[0] * xb.shape[1],
                                      xb.shape[2] * xb.shape[3], xb.dtype)
        dx = emulate_bwd_apply(gb, xb, st, total, count, 1e-5, act, plan)
        assert torch.equal(dx, in_bwd_apply_plain(gb, xb, st, total, count,
                                                  1e-5, act))
        parts.append(dx)
    _, vjp = jax.vjp(lambda a: instance_norm_act_pallas(a, 1e-5, act),
                     jnp.asarray(_nhwc(x)))
    want, = vjp(jnp.asarray(_nhwc(g)))
    _close(torch.cat(parts, dim=2), want)


# in_stats (band entry 1a) on the same kernels: K1's enc0 epilogue is the
# one level of a band that takes it
STATS_CASES = [case for case in CASES if case[1] == 'enc0']


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'fp32'])
@pytest.mark.parametrize('case', STATS_CASES, ids=_id)
def test_band_stats_plan_covers_each_chunk_once(case, dtype):
    """``in_stats``' plan (``band_sums_plan`` on x alone) at the enc0
    bands the card runs, aligned and one element off 16 bytes: every
    element of every plane added once, a plane of at most 1024 chunks on a
    group, a larger one over a cluster of at most 8, each CTA keeping
    BAND_UNROLL chunks a thread in flight."""
    _, _, (n, c, h, w) = case
    planes, plane, esize = n * c, h * w, dtype.itemsize
    for aligned in (True, False):
        plan = na.band_sums_plan(planes, plane, dtype, aligned)
        assert plan.vec == (aligned and plane * esize % 16 == 0)
        chunks = sums_cover(plan, planes, plane, esize)
        if chunks > THREADS * na.BAND_UNROLL:
            assert 1 <= plan.cluster <= na.CLUSTER_MAX
            assert plan.seg >= THREADS * na.BAND_UNROLL
        else:
            assert plan.cluster == 0


@pytest.mark.parametrize('aligned', [True, False], ids=['vec', 'element'])
@pytest.mark.parametrize('shape,k,cluster', SUM_CASES,
                         ids=lambda v: str(v).replace(' ', ''))
def test_band_stats_order_recombined_matches_pallas(shape, k, cluster,
                                                   aligned):
    """fp32: each band's stats in the card's order (emulated under its
    plan: a group, a cluster of 1-8 CTAs, or element by element) within
    1e-5 of max(1, max |stat|) of ``in_stats_plain``; the bands' stats
    added in band order, each band normalised by ``in_apply_plain`` and
    the rows put back together: JAX ``instance_norm_act_pallas``
    (interpret mode) within rtol 1e-3 / atol 1e-4. ``in_stats`` on a CPU
    tensor is its plain version."""
    x, _ = _inputs(shape, 50 + k)
    count = shape[2] * shape[3]
    total = 0
    xs = _bands(x, k)
    for xb in xs:
        planes, plane = xb.shape[0] * xb.shape[1], xb.shape[2] * xb.shape[3]
        plan = na.band_sums_plan(planes, plane, xb.dtype, aligned)
        if cluster:
            plan = _forced(plan, cluster, planes, plane, xb.element_size())
        sums_cover(plan, planes, plane, xb.element_size())
        st = emulate_stats(xb, plan)
        want = in_stats_plain(xb)
        assert torch.equal(in_stats(xb), want)
        assert (st - want).abs().max() <= 1e-5 * max(1.0,
                                                      want.abs().max())
        total = total + st
    y = torch.cat([in_apply_plain(xb, total, count, 1e-5, 'relu')
                   for xb in xs], dim=2)
    want = instance_norm_act_pallas(jnp.asarray(_nhwc(x)), 1e-5, 'relu')
    _close(y, want)


class _Lib:
    """Stands in for a ctypes library: records each entry's argtypes."""

    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, type('Entry', (), {})())


@pytest.mark.parametrize('lib,source', [('_band_lib', 'norm_act'),
                                        ('_band_bwd_lib', 'norm_act_bwd')])
def test_band_ctypes_entries_match_their_c_declarations(monkeypatch, lib,
                                                       source):
    """Each argtypes list the band wrappers give their library names the
    C entry point's parameters in order (``pgt_in_stats`` now takes the
    sums' geometry)."""
    from test_torch_thin_wgrad import c_entries
    fake = _Lib()
    monkeypatch.setattr(na._build, 'load', lambda name: fake)
    base = '_lib' if source == 'norm_act' else '_bwd_lib'
    getattr(na, base).__wrapped__()
    # the band library extends the (cached) base one: hand it the fake
    monkeypatch.setattr(na, base, lambda: fake)
    getattr(na, lib).__wrapped__()
    declared = c_entries(source)
    assert fake.entries
    for name, entry in fake.entries.items():
        assert list(entry.argtypes) == declared[name], name
