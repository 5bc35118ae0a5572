"""K1: affine-free instance norm + activation, and K1-bwd, its backward,
each in two forms: NCHW and NHWC (channels_last).

Port of ``patchgan_tpu/ops/pallas/norm_act.py::instance_norm_act_pallas``:
the forward (``_fwd_kernel``) is ``csrc/norm_act.cu``, the backward
(``_bwd_kernel``) ``csrc/norm_act_bwd.cu``. ``instance_norm_act_plain``
and ``instance_norm_act_backward_plain`` are the same functions in plain
PyTorch, which the wrappers use for CPU tensors and the tests and
``chip_smoke.py`` hold the kernels against. ``InstanceNormAct`` is the
custom VJP (``norm_act.py:290-303``): its only residual is the input x,
and its backward recomputes the statistics from x. ``plane_geometry``
chooses both kernels' launch geometry (how many threads own a plane, how
much of it each holds in registers), which the wrappers pass to the C
entry points.

NHWC form: a CUDA tensor laid out ``torch.channels_last`` (``is_nhwc``)
gets its output in the same layout, from one of two kernels, by size.
Where a (sample, channel tile) fits a thread-block cluster's shared memory
(``nhwc_one_pass_plan``), ``pgt_in_act_nhwc_one_pass`` /
``pgt_in_act_bwd_nhwc_one_pass`` (``csrc/norm_nhwc_cluster.cuh``): one
launch, x (and g) read once; elsewhere the segmented kernels
``pgt_in_act_nhwc`` / ``pgt_in_act_bwd_nhwc`` (``csrc/norm_nhwc.cuh``),
whose blocks take a tile of contiguous channels over a segment of one
sample's pixels (``nhwc_segments`` picks the segments). An NCHW-contiguous
tensor launches the NCHW form; any other layout raises. No wrapper converts a
layout: the autograd backward takes its incoming gradient in the layout of
the saved input (a no-op when the two agree, as on either form's path).
The plain versions keep the input's layout too.

Band forms (spatial parallelism, ``parallel/spatial.py``; ``csrc/band.cuh``):
a plane's rows split over the ranks of a spatial group. ``in_stats`` gives
a band's per-plane fp32 (sum, sum of squares) [N, C, 2]; ``in_apply``
normalises a band from the stats summed over the group and the plane's
global element count; ``in_bwd_sums`` and ``in_bwd_apply`` are K1-bwd's
two halves around the sum of (sum gm, sum gm * xhat). Each has a
``_plain`` version beside it and a ``launches`` count. ``in_stats``,
``in_bwd_sums`` and ``in_bwd_apply`` run ``csrc/band_norm.cuh``'s
kernels, whose geometry ``band_sums_plan`` (a small plane on K1-bwd's
plane machinery, a larger one split over a thread-block cluster; the
same kernels for the statistics and K1-bwd's sums) and
``band_bwd_apply_plan`` (the band walked as one range of 16-byte chunks)
choose.
``instance_norm_act_band`` (``InstanceNormActBand``) is K1 over a band,
the group's sums taken by collectives between the launches; its residuals
are the band and the plane's global stats, so its backward takes one sum
over the group, not two.
"""

import collections
import ctypes
import functools

import torch

from ..activations import apply_activation
from . import _build

# the activations the three fused kernels implement, by kernel code
ACT_CODES = {None: 0, 'linear': 0, 'tanh': 1, 'relu': 2, 'leakyrelu': 3}


def act_code(name):
    if name not in ACT_CODES:
        raise ValueError(f"fused instance norm supports the activations "
                         f"{sorted(map(str, ACT_CODES))}, not {name!r}")
    return ACT_CODES[name]


def dtype_flag(t):
    """Kernel dtype switch: 1 for bfloat16, 0 for float32."""
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"kernels take float32 or bfloat16, not {t.dtype}")


def is_nhwc(t, name='x'):
    """Whether the 4-D tensor t is laid out channels_last (the NHWC forms
    take it) rather than NCHW-contiguous (today's forms); any other layout
    raises. A tensor both describe (H = W = 1, or C = 1) is the same bytes
    either way; its strides say which it was made as, as torch's
    ``suggest_memory_format`` reads them."""
    cl = t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)
    if t.is_contiguous():
        return cl and t.shape[1] > 1 and t.stride(3) != 1
    if cl:
        return True
    raise ValueError(f"{name} {tuple(t.shape)} with strides {t.stride()} is "
                     f"neither NCHW-contiguous nor channels_last")


def memory_format(nhwc):
    return torch.channels_last if nhwc else torch.contiguous_format


def in_layout_of(g, x):
    """g in x's layout: g itself where they agree (both forms' paths),
    else a copy in x's."""
    fmt = memory_format(is_nhwc(x))
    return g if g.is_contiguous(memory_format=fmt) else \
        g.contiguous(memory_format=fmt)


def require(t, name, ndim, like=None, nhwc=False):
    """Device, layout (NCHW-contiguous, or channels_last with ``nhwc``),
    rank and dtype checks before a launch."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=memory_format(nhwc)):
        raise ValueError(f"{name} must be "
                         f"{'channels_last' if nhwc else 'contiguous'}")
    if like is not None and (t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                         f"{like.dtype} on {like.device}")


def require_aligned(t, name):
    """K2's and K3's weights are read in 16-byte vectors; a fresh
    allocation starts on 16 bytes, a view need not."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def needs_graph(*tensors):
    """True when autograd must record this call: grad mode is on and an
    input requires grad. Otherwise (inference_mode, no_grad, constant
    inputs) a kernel runs bare and nothing is saved for a backward."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def instance_norm_act_plain(x, eps=1e-5, activation=None):
    """fp32 statistics per (n, c) plane, var = E[x^2] - mean^2, normalise
    in fp32, activate, cast back to x's dtype."""
    act_code(activation)
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return apply_activation(y, activation).to(x.dtype)


def act_grad(xhat, activation):
    """d act / d xhat, written out as the JAX package's ``_act_grad``
    (``norm_act.py:61-71``): relu' is 0 at 0, leakyrelu' is 1 at 0 (not
    the 0.2 that autograd of ``F.leaky_relu`` gives there)."""
    if activation in (None, 'linear'):
        return torch.ones_like(xhat)
    if activation == 'tanh':
        t = torch.tanh(xhat)
        return 1.0 - t * t
    if activation == 'relu':
        return (xhat > 0).to(xhat.dtype)
    if activation == 'leakyrelu':
        return torch.where(xhat >= 0, 1.0, 0.2).to(xhat.dtype)
    raise ValueError(activation)


def instance_norm_act_backward_plain(g, x, eps=1e-5, activation=None):
    """dx of ``instance_norm_act`` from the output gradient g and the
    input x (``_backward_xla``, norm_act.py:263-277): mean and rstd
    recomputed from x in fp32, gm = g * act'(xhat), dx = rstd * (gm -
    mean(gm) - xhat * mean(gm * xhat)), returned in g's dtype."""
    act_code(activation)
    xf, gf = x.float(), g.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    gm = gf * act_grad(xhat, activation)
    m1 = gm.mean(dim=(2, 3), keepdim=True)
    m2 = (gm * xhat).mean(dim=(2, 3), keepdim=True)
    return (rstd * (gm - m1 - xhat * m2)).to(g.dtype)


# K1's and K1-bwd's launch geometry (csrc/norm_plane.cuh): the block size
# where several planes share a block, the most threads on one plane, and
# the 16-byte chunks of each input a thread holds in registers, by the
# plane's chunk count; set from the variants timed by
# ``tools/norm_act_variants.py --sweep`` (its times are in PERF.md)
SMALL_BLOCK = 256
MAX_GROUP = 512
HELD = (1, 4, 8)      # the chunk counts the kernels are built for


def per_thread_for(chunks):
    """Chunks a thread holds: 1 up to 16 chunks a plane (more lanes
    for the deep levels' 2 x 2 to 8 x 8 planes), 4 up to 1024 (16 x 16
    to 64 x 64 in bf16), 8 above (128 x 128: 256 threads a plane)."""
    return 1 if chunks <= 16 else 4 if chunks <= 1024 else 8


Geometry = collections.namedtuple(
    'Geometry', 'vec group per_thread threads cls grid')


@functools.lru_cache(maxsize=None)
def plane_geometry(planes, plane, dtype, aligned=True, per_thread=None):
    """K1's and K1-bwd's launch geometry for ``planes`` contiguous planes
    of ``plane`` elements of ``dtype``; its first four fields are the C
    entry points' geometry arguments.

    The vector path (``vec``: 16-byte chunks) needs a plane whose bytes
    are a multiple of 16 and ``aligned`` base pointers; otherwise a chunk
    is one element. A group of ``group`` threads (a power of two) owns a
    plane, each thread holding up to ``per_thread`` chunks of each input
    (``per_thread_for`` unless given): the group is the fewest threads
    that hold the whole plane, up to MAX_GROUP. Class ``lanes``: group
    <= 32, SMALL_BLOCK threads a block, several planes a warp or one a
    warp, reduced by shuffles. ``block``: one plane a block of
    ``group`` threads. ``stream``: a block whose plane is larger than its
    registers hold; the rest is read again in each pass."""
    esize = dtype.itemsize
    vec = aligned and plane * esize % 16 == 0
    chunks = plane // (16 // esize) if vec else plane
    per_thread = per_thread or per_thread_for(chunks)
    group = 1
    while group < MAX_GROUP and group * per_thread < chunks:
        group *= 2
    need = -(-chunks // group)
    held = min(h for h in HELD if h >= min(max(need, 1), per_thread))
    if group <= 32:
        cls, threads = 'lanes', SMALL_BLOCK
    else:
        cls, threads = ('block' if need <= per_thread else 'stream'), group
    grid = -(-planes // (threads // group))
    return Geometry(vec, group, held, threads, cls, grid)


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# the NHWC forms' blocks (csrc/norm_nhwc.cuh): threads a block, and the
# blocks the segments aim at (four a streaming multiprocessor of an H100)
NHWC_THREADS = 256
NHWC_TARGET_BLOCKS = 4 * 132


def nhwc_segments(n, hw, c, width):
    """Segments of a sample's ``hw`` pixels an NHWC launch over ``c``
    channels in chunks of ``width`` takes (its grid.x): enough for about
    ``NHWC_TARGET_BLOCKS`` blocks, each thread keeping at least four
    pixels. Mirrors ``nhwc::geo`` for the lanes and tiles."""
    chunks = -(-c // width)
    lanes = 1
    while lanes < chunks and lanes < 32:
        lanes *= 2
    tiles = -(-chunks // lanes)
    rows = NHWC_THREADS // lanes
    want = -(-NHWC_TARGET_BLOCKS // (n * tiles))
    return max(1, min(want, -(-hw // (4 * rows)), 65535))


def nhwc_plan(n, hw, c, dtype, *tensors):
    """(vec, segs) of an NHWC launch: 16-byte vectors where c is a
    multiple of 8 and every tensor starts on 16 bytes, else element by
    element; the segments for that width."""
    vec = c % 8 == 0 and _aligned(*tensors)
    width = 16 // dtype.itemsize if vec else 1
    return vec, nhwc_segments(n, hw, c, width)


# the one-pass NHWC kernels (csrc/norm_nhwc_cluster.cuh): threads a CTA,
# CTAs a cluster (the portable limit), an H100 block's shared memory; the
# planner's aims, set from every geometry timed on an H100
# (``tools/norm_act_variants.py --sweep``; PERF.md): at most 64 KiB staged
# a CTA (three CTAs an SM) and at least 128 CTAs, as long as each CTA
# keeps a pixel for every row of its threads
ONE_PASS_THREADS = 256
CLUSTER_MAX = 8
SMEM_PER_BLOCK = 232448
ONE_PASS_STAGE_AIM = 64 * 1024
ONE_PASS_CTAS_AIM = 128

OnePass = collections.namedtuple('OnePass',
                                 'lanes cluster tiles seg_len smem grid')


def one_pass_smem(cw, cluster, seg_len, tile_bytes, inputs):
    """A CTA's shared memory (``one_pass::check``): two mbarriers, the
    warps' partials, every rank's partials of two phases and two
    coefficient tables over the tile's ``cw`` channels, then ``inputs``
    staged segments of ``seg_len`` pixels of ``tile_bytes``."""
    red = 16 + (ONE_PASS_THREADS // 32 + 2 * cluster + 2) * cw * 8
    return red + seg_len * tile_bytes * inputs


@functools.lru_cache(maxsize=None)
def nhwc_one_pass_plan(n, hw, c, dtype, inputs, aligned=True):
    """The one-pass kernel's geometry for ``inputs`` tensors (1: K1, 2:
    K1-bwd) of (n, hw pixels, c channels) in ``dtype``, or None where it
    cannot take them (the segmented kernels then do).

    c must be a multiple of 8 and every pointer ``aligned`` on 16 bytes. A
    tile is ``lanes`` chunks of 16 bytes of a pixel's channels: the widest
    of 64 and 32 bytes (whole sectors) that divides the pixel and whose
    (sample, tile) an 8-CTA cluster holds, or the whole pixel where it is
    one chunk; up to 128 bytes while a CTA would have fewer than two chunks
    a thread. ``cluster`` CTAs split a tile's ``hw`` pixels into segments
    of ``seg_len``: the fewest whose shared memory (``smem``) fits a
    block's, then more while a CTA stages more than ``ONE_PASS_STAGE_AIM``
    bytes or the grid has fewer than ``ONE_PASS_CTAS_AIM`` CTAs, as long as
    each keeps a pixel for every row of its threads (a row: ``lanes``
    threads on one pixel). None where eight do not fit."""
    if not aligned or c % 8:
        return None
    width = 16 // dtype.itemsize
    chunks = c // width

    def staged(lanes, k):
        return -(-hw // k) * lanes * 16 * inputs

    def smem(lanes, k):
        return one_pass_smem(lanes * width, k, -(-hw // k), lanes * 16,
                             inputs)

    for lanes in (4, 2, 1):
        if chunks % lanes == 0 and (lanes > 1 or chunks == 1) and \
                smem(lanes, CLUSTER_MAX) <= SMEM_PER_BLOCK:
            break
    else:
        return None
    while lanes < 8 and chunks % (2 * lanes) == 0 and \
            hw * lanes < 2 * ONE_PASS_THREADS:
        lanes *= 2
    tiles = chunks // lanes
    cluster = 1
    while smem(lanes, cluster) > SMEM_PER_BLOCK:
        cluster *= 2
    while cluster < CLUSTER_MAX and \
            (staged(lanes, cluster) > ONE_PASS_STAGE_AIM
             or n * tiles * cluster < ONE_PASS_CTAS_AIM) and \
            -(-hw // (2 * cluster)) >= ONE_PASS_THREADS // lanes:
        cluster *= 2
    return OnePass(lanes, cluster, tiles, -(-hw // cluster),
                   smem(lanes, cluster), (cluster, tiles, n))


# the private ``_nhwc_kernel`` argument of the wrappers: which NHWC kernel
# to launch (None: the planner's choice), for timing and checks only
NHWC_KERNELS = (None, 'one_pass', 'segmented')


def _nhwc_choice(kernel, n, hw, c, dtype, inputs, *tensors):
    """The one-pass geometry to launch, or None for the segmented
    kernels."""
    if kernel not in NHWC_KERNELS:
        raise ValueError(f"_nhwc_kernel must be one of {NHWC_KERNELS}, not "
                         f"{kernel!r}")
    if kernel == 'segmented':
        return None
    plan = nhwc_one_pass_plan(n, hw, c, dtype, inputs, _aligned(*tensors))
    if plan is None and kernel == 'one_pass':
        raise ValueError(f"the one-pass NHWC kernel cannot take ({n}, {c}, "
                         f"{hw} px) in {dtype}")
    return plan


# the band forms of K1-bwd's two halves (csrc/band_norm.cuh): threads a
# CTA, the chunks of each input a thread keeps in flight, the CTAs the
# sums of one plane may split over (a cluster: the portable limit), the
# most CTAs a split takes, and dx's grid: at least DX_BLOCKS_MIN blocks
# while a thread keeps more than one chunk, at most 32 an SM of an H100
# (the blocks then walk the range in rounds); set from the geometries
# timed on an H100 by ``tools/norm_act_variants.py --band --sweep``
# (PERF.md)
BAND_THREADS = 256
BAND_UNROLL = 4
BAND_CTAS_AIM = 512
DX_BLOCKS_MIN = 256
DX_BLOCKS_MAX = 32 * 132

BandSums = collections.namedtuple(
    'BandSums', 'vec group per_thread threads cluster seg grid')


@functools.lru_cache(maxsize=None)
def band_sums_plan(planes, plane, dtype, aligned=True):
    """``in_bwd_sums``' and ``in_stats``' launch geometry for ``planes``
    contiguous planes of ``plane`` elements of ``dtype``; its fields from
    ``vec`` to ``cluster`` are the C entry points' geometry arguments.

    A chunk is 16 bytes where the plane's bytes are a multiple of 16 and
    the inputs (g and x, or x) are ``aligned``, else one element. A plane
    of at most BAND_THREADS * BAND_UNROLL chunks takes the group kernel with
    ``plane_geometry``'s (vec, group, per_thread, threads) and ``cluster``
    0. A larger one is split into ``cluster`` segments of ``seg`` chunks,
    a CTA of BAND_THREADS each (``grid`` CTAs in all): twice as many while
    the grid stays within BAND_CTAS_AIM CTAs, each CTA keeps at least
    BAND_UNROLL chunks a thread, and the cluster holds at most
    CLUSTER_MAX."""
    esize = dtype.itemsize
    vec = aligned and plane * esize % 16 == 0
    chunks = plane // (16 // esize) if vec else plane
    if chunks <= BAND_THREADS * BAND_UNROLL:
        geo = plane_geometry(planes, plane, dtype, aligned)
        return BandSums(geo.vec, geo.group, geo.per_thread, geo.threads, 0,
                        chunks, geo.grid)
    cluster = 1
    while cluster < CLUSTER_MAX and planes * 2 * cluster <= BAND_CTAS_AIM \
            and chunks // (2 * cluster) >= BAND_THREADS * BAND_UNROLL:
        cluster *= 2
    return BandSums(vec, BAND_THREADS, BAND_UNROLL, BAND_THREADS, cluster,
                    -(-chunks // cluster), planes * cluster)


BandDx = collections.namedtuple('BandDx', 'vec width unroll grid')


@functools.lru_cache(maxsize=None)
def band_bwd_apply_plan(planes, plane, dtype, aligned=True):
    """``in_bwd_apply``'s launch geometry over ``planes`` contiguous planes
    of ``plane`` elements of ``dtype``; ``vec``, ``unroll`` and ``grid``
    are the C entry point's geometry arguments.

    The range is walked in chunks of 16 bytes (``vec``) where the plane's
    bytes are a multiple of 16 and g, x and dx are ``aligned``, else of
    one element (``width`` elements each). A thread keeps ``unroll``
    chunks of g and x in flight: BAND_UNROLL, halved while the grid would
    have fewer than DX_BLOCKS_MIN blocks; the grid covers the range once,
    or in rounds of at most DX_BLOCKS_MAX blocks."""
    vec = aligned and plane * dtype.itemsize % 16 == 0
    width = 16 // dtype.itemsize if vec else 1
    n = planes * (plane // width)
    unroll = BAND_UNROLL
    while unroll > 1 and -(-n // (BAND_THREADS * unroll)) < DX_BLOCKS_MIN:
        unroll //= 2
    return BandDx(vec, width, unroll,
                  min(-(-n // (BAND_THREADS * unroll)), DX_BLOCKS_MAX))


def f32_scratch(*shape, like):
    """An empty fp32 tensor of ``shape`` on ``like``'s device."""
    return torch.empty(shape, dtype=torch.float32, device=like.device)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('norm_act')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pgt_in_act.argtypes = [p, p, ctypes.c_long, ctypes.c_long, i,
                               ctypes.c_float, i, i, i, i, i, p]
    lib.pgt_in_act.restype = i
    lib.pgt_in_act_nhwc.argtypes = [p] * 4 + [
        ctypes.c_long, ctypes.c_long, i, i, ctypes.c_float, i, i, i, p]
    lib.pgt_in_act_nhwc.restype = i
    lib.pgt_in_act_nhwc_one_pass.argtypes = [p, p, ctypes.c_long,
                                             ctypes.c_long, i, i,
                                             ctypes.c_float, i, i, i, p]
    lib.pgt_in_act_nhwc_one_pass.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = _build.load('norm_act_bwd')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pgt_in_act_bwd.argtypes = [p, p, p, ctypes.c_long, ctypes.c_long,
                                   i, ctypes.c_float, i, i, i, i, i, p]
    lib.pgt_in_act_bwd.restype = i
    lib.pgt_in_act_bwd_nhwc.argtypes = [p] * 6 + [
        ctypes.c_long, ctypes.c_long, i, i, ctypes.c_float, i, i, i, p]
    lib.pgt_in_act_bwd_nhwc.restype = i
    lib.pgt_in_act_bwd_nhwc_one_pass.argtypes = [p, p, p, ctypes.c_long,
                                                 ctypes.c_long, i, i,
                                                 ctypes.c_float, i, i, i, p]
    lib.pgt_in_act_bwd_nhwc_one_pass.restype = i
    return lib


def _forward(x, eps, activation, nhwc_kernel=None):
    """K1 on a CUDA tensor, the plain version on a CPU tensor; never
    recorded by autograd."""
    if x.is_cpu:
        return instance_norm_act_plain(x, eps, activation)
    act = act_code(activation)
    if x.dim() == 4 and is_nhwc(x):
        return _forward_nhwc(x, eps, act, nhwc_kernel)
    require(x, 'x', 4)
    flag = dtype_flag(x)
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    if not n * c * h * w:
        return y
    geo = plane_geometry(n * c, h * w, x.dtype, _aligned(x, y))
    with _build.device_guard(x):
        rc = _lib().pgt_in_act(x.data_ptr(), y.data_ptr(), n * c, h * w,
                               act, eps, flag, *geo[:4], _build.stream_of(x))
    _build.check(rc, 'instance_norm_act')
    instance_norm_act.launches += 1
    return y


def _forward_nhwc(x, eps, act, kernel=None):
    """K1's NHWC form on a channels_last CUDA tensor: the one-pass kernel
    where ``nhwc_one_pass_plan`` takes the call, else the segmented
    kernels (``kernel`` forces one)."""
    require(x, 'x', 4, nhwc=True)
    n, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if not n * c * h * w:
        return y
    plan = _nhwc_choice(kernel, n, h * w, c, x.dtype, 1, x, y)
    with _build.device_guard(x):
        if plan is not None:
            rc = _lib().pgt_in_act_nhwc_one_pass(
                x.data_ptr(), y.data_ptr(), n, h * w, c, act, eps,
                dtype_flag(x), plan.lanes, plan.cluster, _build.stream_of(x))
        else:
            vec, segs = nhwc_plan(n, h * w, c, x.dtype, x, y)
            part = f32_scratch(n * c * segs, 2, like=x)
            stats = f32_scratch(n * c, 2, like=x)
            rc = _lib().pgt_in_act_nhwc(
                x.data_ptr(), y.data_ptr(), part.data_ptr(),
                stats.data_ptr(), n, h * w, c, act, eps, dtype_flag(x),
                int(vec), segs, _build.stream_of(x))
    _build.check(rc, 'instance_norm_act (NHWC)')
    instance_norm_act.launches += 1
    instance_norm_act.launches_nhwc += 1
    instance_norm_act.launches_one_pass += plan is not None
    return y


def _backward_nhwc(g, x, eps, act, kernel=None):
    """K1-bwd's NHWC form on channels_last CUDA tensors: the one-pass
    kernel where ``nhwc_one_pass_plan`` takes the call, else the segmented
    kernels (``kernel`` forces one)."""
    require(g, 'g', 4, nhwc=True)
    require(x, 'x', 4, like=g, nhwc=True)
    n, c, h, w = g.shape
    dx = torch.empty_like(g, memory_format=torch.channels_last)
    if not n * c * h * w:
        return dx
    plan = _nhwc_choice(kernel, n, h * w, c, g.dtype, 2, g, x, dx)
    with _build.device_guard(g):
        if plan is not None:
            rc = _bwd_lib().pgt_in_act_bwd_nhwc_one_pass(
                g.data_ptr(), x.data_ptr(), dx.data_ptr(), n, h * w, c, act,
                eps, dtype_flag(g), plan.lanes, plan.cluster,
                _build.stream_of(g))
        else:
            vec, segs = nhwc_plan(n, h * w, c, g.dtype, g, x, dx)
            part = f32_scratch(n * c * segs, 2, like=g)
            stats = f32_scratch(n * c, 2, like=g)
            sums = f32_scratch(n * c, 2, like=g)
            rc = _bwd_lib().pgt_in_act_bwd_nhwc(
                g.data_ptr(), x.data_ptr(), dx.data_ptr(), part.data_ptr(),
                stats.data_ptr(), sums.data_ptr(), n, h * w, c, act, eps,
                dtype_flag(g), int(vec), segs, _build.stream_of(g))
    _build.check(rc, 'instance_norm_act_backward (NHWC)')
    instance_norm_act_backward.launches += 1
    instance_norm_act_backward.launches_nhwc += 1
    instance_norm_act_backward.launches_one_pass += plan is not None
    return dx


def instance_norm_act_backward(g, x, eps=1e-5, activation=None, *,
                               _nhwc_kernel=None):
    """dx from g and x, both (N, C, H, W) of one dtype and one layout. A
    CPU tensor takes the plain version; a CUDA tensor launches K1-bwd, in
    its NHWC form where both are channels_last (``_nhwc_kernel``, private:
    'one_pass' or 'segmented' forces that kernel, for timing and checks)."""
    if g.is_cpu:
        return instance_norm_act_backward_plain(g, x, eps, activation)
    act = act_code(activation)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} and x {tuple(x.shape)} "
                         f"differ")
    if g.dim() == 4 and is_nhwc(g, 'g'):
        return _backward_nhwc(g, x, eps, act, _nhwc_kernel)
    require(g, 'g', 4)
    require(x, 'x', 4, like=g)
    flag = dtype_flag(g)
    n, c, h, w = g.shape
    dx = torch.empty_like(g)
    if not n * c * h * w:
        return dx
    geo = plane_geometry(n * c, h * w, g.dtype, _aligned(g, x, dx))
    with _build.device_guard(g):
        rc = _bwd_lib().pgt_in_act_bwd(
            g.data_ptr(), x.data_ptr(), dx.data_ptr(), n * c, h * w, act,
            eps, flag, *geo[:4], _build.stream_of(g))
    _build.check(rc, 'instance_norm_act_backward')
    instance_norm_act_backward.launches += 1
    return dx


instance_norm_act_backward.launches = 0
# the NHWC form's launches alone (``launches`` counts both forms'), and of
# them the one-pass kernel's
instance_norm_act_backward.launches_nhwc = 0
instance_norm_act_backward.launches_one_pass = 0


class InstanceNormAct(torch.autograd.Function):
    """K1 forward, K1-bwd backward; the residual is x alone."""

    @staticmethod
    def forward(ctx, x, eps, activation):
        ctx.save_for_backward(x)
        ctx.eps, ctx.activation = eps, activation
        return _forward(x, eps, activation)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        dx = instance_norm_act_backward(in_layout_of(g.to(x.dtype), x), x,
                                        ctx.eps, ctx.activation)
        return dx, None, None


def instance_norm_act(x, eps=1e-5, activation=None, *, _nhwc_kernel=None):
    """x: (N, C, H, W), NCHW-contiguous or channels_last. A CPU tensor
    takes the plain version; a CUDA tensor launches K1 in the form of its
    layout, the output in that layout. Differentiable through
    ``InstanceNormAct``. ``_nhwc_kernel`` (private): as
    ``instance_norm_act_backward``'s, for a call autograd does not
    record."""
    if needs_graph(x):
        return InstanceNormAct.apply(x, eps, activation)
    return _forward(x, eps, activation, _nhwc_kernel)


instance_norm_act.launches = 0
# the NHWC form's launches alone (``launches`` counts both forms'), and of
# them the one-pass kernel's
instance_norm_act.launches_nhwc = 0
instance_norm_act.launches_one_pass = 0


# band forms


def in_stats_plain(x):
    """[N, C, 2] fp32 (sum, sum of squares) of each plane of x's band."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))],
                       dim=-1)


def _mean_rstd(stats, count, eps):
    """(mean, rstd) [N, C, 1, 1] from a plane's global stats."""
    mean = stats[..., 0] / count
    var = stats[..., 1] / count - mean * mean
    return mean[..., None, None], torch.rsqrt(var + eps)[..., None, None]


def in_apply_plain(x, stats, count, eps=1e-5, activation=None, dtype=None):
    """act((x - mean) * rstd) in fp32, mean and rstd from the plane's
    global ``stats`` and element ``count``, cast to ``dtype`` (x's when
    None)."""
    act_code(activation)
    mean, rstd = _mean_rstd(stats, count, eps)
    y = (x.float() - mean) * rstd
    return apply_activation(y, activation).to(dtype or x.dtype)


def _band_terms(g, x, stats, count, eps, activation):
    mean, rstd = _mean_rstd(stats, count, eps)
    xhat = (x.float() - mean) * rstd
    return rstd, xhat, g.float() * act_grad(xhat, activation)


def in_bwd_sums_plain(g, x, stats, count, eps=1e-5, activation=None):
    """[N, C, 2] fp32 (sum gm, sum gm * xhat) of each plane of the band."""
    act_code(activation)
    _, xhat, gm = _band_terms(g, x, stats, count, eps, activation)
    return torch.stack([gm.sum(dim=(2, 3)), (gm * xhat).sum(dim=(2, 3))],
                       dim=-1)


def in_bwd_apply_plain(g, x, stats, sums, count, eps=1e-5, activation=None):
    """The band's dx = rstd * (gm - m1 - xhat * m2), m1 and m2 the plane's
    global ``sums`` over ``count``, in g's dtype."""
    act_code(activation)
    rstd, xhat, gm = _band_terms(g, x, stats, count, eps, activation)
    m1 = (sums[..., 0] / count)[..., None, None]
    m2 = (sums[..., 1] / count)[..., None, None]
    return (rstd * (gm - m1 - xhat * m2)).to(g.dtype)


def _pair_buffer(x):
    n, c = x.shape[:2]
    return torch.empty((n, c, 2), dtype=torch.float32, device=x.device)


def _require_stats(t, name, like):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(like.shape[:2]) \
            + (2,) or not t.is_contiguous() or t.device != like.device:
        raise ValueError(f"{name} must be contiguous fp32 "
                         f"{tuple(like.shape[:2]) + (2,)} on {like.device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _planes(x):
    n, c, h, w = x.shape
    if not n * c * h * w:
        raise ValueError(f"a band kernel needs a non-empty band, got "
                         f"{tuple(x.shape)}")
    return n * c, h * w


@functools.lru_cache(maxsize=None)
def _band_lib():
    lib = _lib()
    p, i, lg, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
    lib.pgt_in_stats.argtypes = [p, p, lg, lg] + [i] * 6 + [p]
    lib.pgt_in_stats.restype = i
    lib.pgt_in_apply.argtypes = [p, p, p, lg, lg, f, i, f, i, i, p]
    lib.pgt_in_apply.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _band_bwd_lib():
    lib = _bwd_lib()
    p, i, lg, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
    lib.pgt_in_bwd_sums.argtypes = [p, p, p, p, lg, lg, f, i, f] + [i] * 6 \
        + [p]
    lib.pgt_in_bwd_sums.restype = i
    lib.pgt_in_bwd_apply.argtypes = [p, p, p, p, p, lg, lg, f, i, f, i, i,
                                     i, lg, p]
    lib.pgt_in_bwd_apply.restype = i
    return lib


def in_stats(x):
    """A band's per-plane stats [N, C, 2] fp32. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel, on the sums' kernels
    at ``band_sums_plan``'s geometry."""
    if x.is_cpu:
        return in_stats_plain(x)
    require(x, 'x', 4)
    flag = dtype_flag(x)
    planes, plane = _planes(x)
    stats = _pair_buffer(x)
    plan = band_sums_plan(planes, plane, x.dtype, _aligned(x))
    with _build.device_guard(x):
        rc = _band_lib().pgt_in_stats(x.data_ptr(), stats.data_ptr(),
                                      planes, plane, flag, int(plan.vec),
                                      plan.group, plan.per_thread,
                                      plan.threads, plan.cluster,
                                      _build.stream_of(x))
    _build.check(rc, 'in_stats')
    in_stats.launches += 1
    return stats


in_stats.launches = 0


def in_apply(x, stats, count, eps=1e-5, activation=None, dtype=None):
    """Normalise and activate a band (fp32 or bf16) from the plane's global
    ``stats`` and element ``count`` into ``dtype`` (x's when None; a fused
    conv's fp32 output goes to the compute dtype). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel."""
    if x.is_cpu:
        return in_apply_plain(x, stats, count, eps, activation, dtype)
    act = act_code(activation)
    require(x, 'x', 4)
    _require_stats(stats, 'stats', x)
    y = torch.empty(x.shape, dtype=dtype or x.dtype, device=x.device)
    planes, plane = _planes(x)
    with _build.device_guard(x):
        rc = _band_lib().pgt_in_apply(
            x.data_ptr(), stats.data_ptr(), y.data_ptr(), planes, plane,
            float(count), act, eps, dtype_flag(x), dtype_flag(y),
            _build.stream_of(x))
    _build.check(rc, 'in_apply')
    in_apply.launches += 1
    return y


in_apply.launches = 0


def in_bwd_sums(g, x, stats, count, eps=1e-5, activation=None):
    """A band's per-plane (sum gm, sum gm * xhat) [N, C, 2] fp32. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    if g.is_cpu:
        return in_bwd_sums_plain(g, x, stats, count, eps, activation)
    act = act_code(activation)
    require(g, 'g', 4)
    require(x, 'x', 4, like=g)
    _require_stats(stats, 'stats', x)
    planes, plane = _planes(x)
    sums = _pair_buffer(x)
    plan = band_sums_plan(planes, plane, g.dtype, _aligned(g, x))
    with _build.device_guard(g):
        rc = _band_bwd_lib().pgt_in_bwd_sums(
            g.data_ptr(), x.data_ptr(), stats.data_ptr(), sums.data_ptr(),
            planes, plane, float(count), act, eps, dtype_flag(g),
            int(plan.vec), plan.group, plan.per_thread, plan.threads,
            plan.cluster, _build.stream_of(g))
    _build.check(rc, 'in_bwd_sums')
    in_bwd_sums.launches += 1
    return sums


in_bwd_sums.launches = 0


def in_bwd_apply(g, x, stats, sums, count, eps=1e-5, activation=None):
    """The band's dx from the plane's global ``stats`` and ``sums``. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    if g.is_cpu:
        return in_bwd_apply_plain(g, x, stats, sums, count, eps, activation)
    act = act_code(activation)
    require(g, 'g', 4)
    require(x, 'x', 4, like=g)
    _require_stats(stats, 'stats', x)
    _require_stats(sums, 'sums', x)
    planes, plane = _planes(x)
    dx = torch.empty_like(g)
    plan = band_bwd_apply_plan(planes, plane, g.dtype, _aligned(g, x, dx))
    with _build.device_guard(g):
        rc = _band_bwd_lib().pgt_in_bwd_apply(
            g.data_ptr(), x.data_ptr(), stats.data_ptr(), sums.data_ptr(),
            dx.data_ptr(), planes, plane, float(count), act, eps,
            dtype_flag(g), int(plan.vec), plan.unroll, plan.grid,
            _build.stream_of(g))
    _build.check(rc, 'in_bwd_apply')
    in_bwd_apply.launches += 1
    return dx


in_bwd_apply.launches = 0


def band_backward(g, x, stats, count, eps, activation, axis, group):
    """dx of K1 over a band: ``in_bwd_sums``, their sum over the spatial
    ``axis`` (on ``group``), ``in_bwd_apply``."""
    sums = in_bwd_sums(g, x, stats, count, eps, activation)
    axis.all_reduce(sums, group)
    return in_bwd_apply(g, x, stats, sums, count, eps, activation)


class InstanceNormActBand(torch.autograd.Function):
    """K1 over a band: stats, their sum over the axis, apply; the backward
    is ``band_backward``. Residuals: x and the plane's global stats."""

    @staticmethod
    def forward(ctx, x, eps, activation, axis, group, count):
        stats = in_stats(x)
        axis.all_reduce(stats, group)
        ctx.save_for_backward(x, stats)
        ctx.eps, ctx.activation = eps, activation
        ctx.axis, ctx.group, ctx.count = axis, group, count
        return in_apply(x, stats, count, eps, activation)

    @staticmethod
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        dx = band_backward(g.to(x.dtype).contiguous(), x, stats, ctx.count,
                           ctx.eps, ctx.activation, ctx.axis, ctx.group)
        return dx, None, None, None, None, None


def instance_norm_act_band(x, eps, activation, axis, count):
    """``instance_norm_act`` of the whole plane, on this rank's band x
    (N, C, h, W) of it: the statistics summed over the spatial ``axis``
    (``parallel.spatial.SpatialAxis``), ``count`` the plane's global
    element count. Differentiable through ``InstanceNormActBand``."""
    x = x.contiguous()
    group = axis.group_now()
    if needs_graph(x):
        return InstanceNormActBand.apply(x, eps, activation, axis, group,
                                         count)
    stats = in_stats(x)
    axis.all_reduce(stats, group)
    return in_apply(x, stats, count, eps, activation)
