"""K2: conv(k=4, s=2, p=1, no bias) + instance norm + activation, NCHW
or NHWC (channels_last) input, OIHW weight, with its gradient.

Port of ``patchgan_tpu/ops/pallas/conv_norm_act.py::fused_conv_norm_act``.
The CUDA kernel is ``csrc/conv_norm_act.cu``; ``conv_norm_act_plain`` is
the same function in plain PyTorch (CPU tensors, tests, and the kernel's
oracle on the card). ``ConvNormAct`` is the custom VJP of
``conv_norm_act.py:194-211``: residuals (x, w); the backward recomputes
the conv output in the compute dtype (cuDNN; the JAX package leaves this
conv to XLA), runs K1-bwd on it, and takes dx and dw through the
recomputed conv.

Forms: an NCHW-contiguous x launches ``pgt_conv_in_act``, its output
NCHW; a channels_last x (``norm_act.is_nhwc``) with a channels_last
weight ``pgt_conv_in_act_nhwc`` (an NHWC problem, the finish of
``csrc/norm_nhwc.cuh``), its output channels_last; anything else raises.
The host planner ``nhwc_gemm_plan`` (``conv_nhwc_plan``, the plan of both
forms) picks the GEMM core: in bf16 with every channel run (Cin, Cout) a
multiple of 64 and x and w on 16 bytes the Hopper core of
``csrc/conv_wgmma.cuh`` (wgmma fed by an async-copy ring, its tile, ring
depth, K split and samples a tile from the plan), otherwise the WMMA core
of ``csrc/conv_gemm.cuh``. On the wgmma core the NCHW form's C call first
copies x into channels_last scratch and the weight into [Cout, 4, 4, Cin]
(the layout pass, ``nchw_to_nhwc``), and ends in the stats and
``in_apply``'s kernel writing y in NCHW. A failure of either core raises;
neither stands in for the other. The private arguments ``_core`` (the
NCHW form's) and ``_nhwc_core`` (the NHWC form's), 'wgmma' or 'wmma', or
('wgmma', BN, stages), force a core, for timing and checks only, and
raise where it cannot, or where x is in the other layout.
``conv_norm_act.launches_wgmma`` counts both forms' launches on the
wgmma core. The backward's recompute (cuDNN) and K1-bwd run in x's
layout: in channels_last the incoming gradient is taken in the
recompute's layout, never flattened to NCHW.

Band form (spatial parallelism, ``parallel/spatial.py``): ``conv_band``
takes a rank's NCHW band of rows with one halo row above and below (zero
rows at the image's edges, ``SpatialAxis.halo``) and launches
``pgt_conv_band`` with no padding of H, writing the band's fp32 conv
output (NCHW) and its per-plane stats. Its core is the planner's
(``conv_band_plan``): in bf16 with Cin and Cout multiples of 64 the wgmma
core, after the layout pass in the same C call copies the band into
channels_last scratch and the weight into [Cout, 4, 4, Cin]
(``nchw_to_nhwc`` is that pass alone, ``nchw_to_nhwc_plain`` its plain
version, a test helper); otherwise the WMMA core on the NCHW band. A
failure raises; neither core stands in for the other. The private
``_core`` argument forces one as in ``conv_norm_act``.
``conv_norm_act_band`` (``ConvNormActBand``) sums the stats over the
spatial group and finishes with ``in_apply``. Its backward,
``recompute_band_grads``, recomputes the conv on the haloed band and runs
K1-bwd's band form with the forward's global stats.
"""

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .norm_act import (_aligned, act_code, band_backward, dtype_flag,
                       f32_scratch, in_apply, in_layout_of, in_stats_plain,
                       instance_norm_act_backward, instance_norm_act_plain,
                       is_nhwc, needs_graph, nhwc_plan, require,
                       require_aligned)


def conv_norm_act_plain(x, w, eps=1e-5, activation=None):
    """fp32 conv of the given values, then the fp32 norm and activation,
    cast back to x's dtype: the conv output is never rounded before the
    statistics, as in the kernel."""
    acc = F.conv2d(x.float(), w.float(), stride=2, padding=1)
    return instance_norm_act_plain(acc, eps, activation).to(x.dtype)


# The GEMM cores of K2 and K3 (NHWC and NCHW forms). The wgmma core
# (csrc/conv_wgmma.cuh): tiles of 64 rows by BN output channels, K steps of
# 64 channels of one tap, a ring of `stages` of (64 + BN) rows of 128 bytes
# in dynamic shared memory; two blocks an SM at BN = 128 and four stages,
# so the K split aims at one wave of that many blocks. Three stages fit
# three blocks an SM; a grid takes them where that makes fewer waves
# (timed on an H100 by ``tools/conv_nhwc_variants.py --sweep``; PERF.md).
# The WMMA core (csrc/conv_gemm.cuh): 64 x 64 tiles, K steps of 32, eight
# blocks an SM (choose_splits, mirrored here).
NHWC_CORES = ('wgmma', 'wmma')
WGMMA_BM = 64
WGMMA_BK = 64
WGMMA_BNS = (128, 64)
WGMMA_STAGES = (4, 3)
SMS = 132
SMEM_PER_SM = 233472   # an H100 SM's shared memory (1 KB of it a block's)
WGMMA_TARGET_BLOCKS = 2 * SMS
WGMMA_MIN_STEPS = 4
WMMA_BM, WMMA_BN, WMMA_BK = 64, 64, 32
WMMA_TARGET_BLOCKS = 4 * SMS
SMEM_PER_BLOCK = 232448

GemmPlan = collections.namedtuple(
    'GemmPlan', 'core bn stages splits samples tiles parts smem')


def wgmma_smem(bn, stages):
    """Dynamic shared memory of a wgmma block (``wg::smem_bytes``): the
    ring, or the epilogue's fp32 tile where larger, and 1024 bytes to put
    the ring on the swizzle's period."""
    return max(stages * (WGMMA_BM + bn) * 128, WGMMA_BM * (bn + 8) * 4) + \
        1024


def wgmma_waves(blocks, bn, stages):
    """Waves of a wgmma grid of ``blocks`` on the card: blocks an SM as
    the shared memory holds them (two at BN 128 and four stages, three at
    three stages)."""
    per_sm = SMEM_PER_SM // (wgmma_smem(bn, stages) + 1024)
    return -(-blocks // (SMS * per_sm))


def _doubled(blocks, steps, target, min_steps, fits):
    """The K split: doubled from 1 while ``fits(blocks * s)`` and each
    split keeps ``min_steps`` of the ``steps`` K steps."""
    s = 1
    while fits(blocks * s, target) and steps // (2 * s) >= min_steps:
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def nhwc_gemm_plan(m, groups, runs, taps, cout, dtype, aligned, split_batch,
                   core=None):
    """The GEMM of a K2 or K3 launch (any form): ``m`` output pixels a
    (sample, class), ``groups`` classes (K3's 4 output parities, K2's 1),
    the input's channel ``runs`` (K2: (Cin,); K3: (Cx, Cs)), ``taps`` taps
    a class (16; 4), ``cout`` output channels, ``aligned``: x (and skip)
    and the weight on 16 bytes. The K split is the one a batch of
    ``split_batch`` samples takes, never a function of the batch itself.

    The wgmma core where the dtype is bf16, every channel run and Cout are
    multiples of 64 and ``aligned``: BN = 128 where it divides Cout, else
    64; a tile packs 64 / m samples where m < 64, otherwise a sample takes
    ceil(m / 64) tiles; the split doubles while the doubled grid still
    fits one wave of ``WGMMA_TARGET_BLOCKS`` and each split keeps
    ``WGMMA_MIN_STEPS`` K steps; three stages where the grid then runs in
    fewer waves than at four (``wgmma_waves``), else four. The stages and BN
    change no sum's order: only the split and the packing do, and they
    follow ``split_batch``. Otherwise the WMMA core with
    ``choose_splits``' split. ``core`` ('wgmma', 'wmma' or ('wgmma', BN,
    stages)) forces one, and raises ValueError where it cannot. Returns a
    ``GemmPlan``: ``parts`` partials a (sample, channel) plane, ``smem``
    the block's dynamic shared memory (0 for the WMMA core's static 19
    KB)."""
    name, bn, stages = (core, None, None) if not isinstance(core, tuple) \
        else core
    if name is not None and name not in NHWC_CORES:
        raise ValueError(f"_nhwc_core must be one of {NHWC_CORES} or "
                         f"('wgmma', BN, stages), not {core!r}")
    why = [w for w, bad in (
        ('not bf16', dtype != torch.bfloat16),
        (f'channel runs {tuple(runs)} not all multiples of {WGMMA_BK}',
         any(r % WGMMA_BK for r in runs)),
        (f'Cout {cout} not a multiple of {WGMMA_BK}', cout % WGMMA_BK),
        ('x, skip or w off 16 bytes', not aligned)) if bad]
    if name == 'wgmma' and why:
        raise ValueError(f"the wgmma core cannot take this call: "
                         f"{', '.join(why)}")
    k = taps * sum(runs)
    if name == 'wmma' or (name is None and why):
        tiles = -(-m // WMMA_BM)
        blocks = tiles * -(-cout // WMMA_BN) * split_batch * groups
        splits = _doubled(blocks, -(-k // WMMA_BK), WMMA_TARGET_BLOCKS, 8,
                          lambda b, t: b < t)
        return GemmPlan('wmma', WMMA_BN, 2, splits, 1, tiles, groups * tiles,
                        0)
    bn = bn or (128 if cout % 128 == 0 else 64)
    if bn not in WGMMA_BNS or cout % bn or \
            stages not in (None,) + WGMMA_STAGES:
        raise ValueError(f"the wgmma core takes BN in {WGMMA_BNS} dividing "
                         f"Cout {cout} and stages in {WGMMA_STAGES}, not "
                         f"({bn}, {stages})")
    samples = WGMMA_BM // m if m < WGMMA_BM else 1
    tiles = 1 if samples > 1 else -(-m // WGMMA_BM)
    rows = -(-split_batch // samples) if samples > 1 else \
        split_batch * tiles
    blocks = rows * groups * (cout // bn)
    splits = _doubled(blocks, k // WGMMA_BK, WGMMA_TARGET_BLOCKS,
                      WGMMA_MIN_STEPS, lambda b, t: 2 * b <= t)
    grid = blocks * splits
    stages = stages or (3 if wgmma_waves(grid, bn, 3) <
                        wgmma_waves(grid, bn, 4) else 4)
    return GemmPlan('wgmma', bn, stages, min(splits, 65535 // groups),
                    samples, tiles, groups * tiles, wgmma_smem(bn, stages))


def conv_nhwc_plan(n, cin, h, w, cout, dtype, aligned=True,
                   split_batch=None, core=None):
    """``nhwc_gemm_plan`` of K2's whole-plane forms (NHWC, and NCHW,
    whose wgmma core reads the layout pass's channels_last copies) on x
    (n, cin, h, w) and a (cout, cin, 4, 4) weight; ``aligned``: x and the
    weight on 16 bytes."""
    ho, wo = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    return nhwc_gemm_plan(ho * wo, 1, (cin,), 16, cout, dtype, aligned,
                          split_batch or n, core)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('conv_norm_act')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pgt_conv_in_act.argtypes = [p] * 8 + [i] * 7 + [ctypes.c_float] + \
        [i] * 6 + [p]
    lib.pgt_conv_in_act.restype = i
    lib.pgt_conv_band.argtypes = [p] * 7 + [i] * 12 + [p]
    lib.pgt_conv_band.restype = i
    lib.pgt_nchw_to_nhwc.argtypes = [p, p, i, i, ctypes.c_long, p]
    lib.pgt_nchw_to_nhwc.restype = i
    lib.pgt_conv_in_act_nhwc.argtypes = [p] * 6 + [i] * 7 + [
        ctypes.c_float] + [i] * 9 + [p]
    lib.pgt_conv_in_act_nhwc.restype = i
    lib.pgt_tile_k.argtypes = []
    lib.pgt_tile_k.restype = i
    return lib


def _forward(x, w, eps, activation, split_batch=None, core=None,
             nhwc_core=None):
    """K2 on CUDA tensors, the plain version on CPU tensors; never
    recorded by autograd. ``core`` / ``nhwc_core``: the NCHW / NHWC
    form's core forced (checked on CPU tensors too)."""
    forced = forced_core(x, core, nhwc_core)
    if forced is not None:
        n, cin, h, wd = x.shape
        plan = conv_nhwc_plan(n, cin, h, wd, w.shape[0], x.dtype,
                              _aligned(x, w), split_batch, forced)
    if x.device.type == 'cpu':
        return conv_norm_act_plain(x, w, eps, activation)
    act = act_code(activation)
    nhwc = x.dim() == 4 and is_nhwc(x)
    require(x, 'x', 4, nhwc=nhwc)
    require(w, 'w', 4, like=x, nhwc=nhwc)
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 4, 4):
        raise ValueError(f"w must be ({cout}, {cin}, 4, 4), got "
                         f"{tuple(w.shape)}")
    ho, wo = (h - 2) // 2 + 1, (wd - 2) // 2 + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"input {h}x{wd} is too small for k=4, s=2, p=1")
    require_aligned(w, 'w')
    if forced is None:
        plan = conv_nhwc_plan(n, cin, h, wd, cout, x.dtype, _aligned(x, w),
                              split_batch)
    return (_forward_nhwc if nhwc else _forward_nchw)(
        _lib(), x, w, act, eps, split_batch, plan)


def forced_core(x, core, nhwc_core):
    """The core forced on a call in x's layout, or None: ``core`` the NCHW
    form's, ``nhwc_core`` the NHWC form's; either given for the other
    layout raises ValueError."""
    if core is None and nhwc_core is None:
        return None
    nhwc = x.dim() == 4 and is_nhwc(x)
    if nhwc_core is not None and not nhwc:
        raise ValueError('_nhwc_core needs a channels_last x')
    if core is not None and nhwc:
        raise ValueError('_core forces the NCHW form\'s core; a '
                         'channels_last x takes _nhwc_core')
    return nhwc_core if nhwc else core


def _forward_nchw(lib, x, w, act, eps, split_batch, plan):
    """K2's NCHW form on NCHW-contiguous x and w (checked by ``_forward``)
    on the core ``plan`` (``conv_nhwc_plan``) names: on the wgmma core the
    layout pass's channels_last copies of x and w, the GEMM, the stats and
    the apply, one C call."""
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    ho, wo = (h - 2) // 2 + 1, (wd - 2) // 2 + 1
    y = torch.empty((n, cout, ho, wo), dtype=x.dtype, device=x.device)
    wgmma = plan.core == 'wgmma'
    # fp32 conv output, one copy per K split
    acc = f32_scratch(plan.splits * y.numel(), like=x)
    part = f32_scratch(n * cout * plan.parts, 2, like=x)
    stats = f32_scratch(n * cout, 2, like=x) if wgmma else None
    # the layout pass's channels_last copies of x and the weight
    xt, wt = (torch.empty(t.numel(), dtype=t.dtype, device=t.device)
              if wgmma else None for t in (x, w))
    with _build.device_guard(x):
        rc = lib.pgt_conv_in_act(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), acc.data_ptr(),
            part.data_ptr(), _ptr(xt), _ptr(wt), _ptr(stats), n,
            split_batch or n, cin, h, wd, cout, act, eps, dtype_flag(x),
            int(wgmma), plan.bn, plan.stages, plan.splits, plan.samples,
            _build.stream_of(x))
    _build.check(rc, f'conv_norm_act ({plan.core} core)')
    conv_norm_act.launches += 1
    conv_norm_act.launches_wgmma += wgmma
    return y


def _forward_nhwc(lib, x, w, act, eps, split_batch, plan):
    """K2's NHWC form on channels_last x and w (checked by ``_forward``) on
    the core ``plan`` (``conv_nhwc_plan``) names."""
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    ho, wo = (h - 2) // 2 + 1, (wd - 2) // 2 + 1
    y = torch.empty((n, cout, ho, wo), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    acc = f32_scratch(plan.splits * n * ho * wo * cout, like=x)
    vec, segs = nhwc_plan(n, ho * wo, cout, x.dtype, acc, y)
    part = f32_scratch(n * cout * max(plan.parts, segs), 2, like=x)
    stats = f32_scratch(n * cout, 2, like=x)
    x_vec = cin % lib.pgt_tile_k() == 0 and x.data_ptr() % 16 == 0
    wgmma = plan.core == 'wgmma'
    with _build.device_guard(x):
        rc = lib.pgt_conv_in_act_nhwc(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), acc.data_ptr(),
            part.data_ptr(), stats.data_ptr(), n, split_batch or n, cin, h,
            wd, cout, act, eps, dtype_flag(x), int(x_vec), int(vec), segs,
            int(wgmma), plan.bn, plan.stages, plan.splits, plan.samples,
            _build.stream_of(x))
    _build.check(rc, f'conv_norm_act (NHWC, {plan.core} core)')
    conv_norm_act.launches += 1
    conv_norm_act.launches_nhwc += 1
    conv_norm_act.launches_wgmma += wgmma
    return y


def recompute_grads(ctx, g, conv, inputs):
    """The shared backward of K2 and K3: ``conv(*inputs)`` recomputed in
    the compute dtype, K1-bwd on it, then the input gradients that
    ``ctx.needs_input_grad`` asks for through the recomputed conv (None
    for the rest). ``recompute_grads.launches`` counts the recomputes."""
    want = [t is not None and need
            for t, need in zip(inputs, ctx.needs_input_grad)]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(inputs, want)]
        out = conv(*leaves)
    recompute_grads.launches += 1
    dout = instance_norm_act_backward(in_layout_of(g.to(out.dtype), out),
                                      out.detach(), ctx.eps, ctx.activation)
    wanted = [t for t, need in zip(leaves, want) if need]
    found = iter(torch.autograd.grad(out, wanted, dout)) if wanted else None
    return [next(found) if need else None for need in want]


recompute_grads.launches = 0


def _conv(x, w):
    return F.conv2d(x, w, stride=2, padding=1)


class ConvNormAct(torch.autograd.Function):
    """K2 forward; backward by recompute + K1-bwd. Residuals (x, w)."""

    @staticmethod
    def forward(ctx, x, w, eps, activation, split_batch, core, nhwc_core):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.activation = eps, activation
        return _forward(x, w, eps, activation, split_batch, core, nhwc_core)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = recompute_grads(ctx, g, _conv, (x, w))
        return dx, dw, None, None, None, None, None


def conv_norm_act(x, w, eps=1e-5, activation=None, split_batch=None, *,
                  _core=None, _nhwc_core=None):
    """x: (N, Cin, H, W), w: (Cout, Cin, 4, 4) in x's dtype and layout
    (NCHW-contiguous, or both channels_last). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel in the form of its layout,
    the output in that layout.
    ``split_batch``: the kernel takes the K split of a batch of that many
    samples (default N, the fastest); held fixed, each sample's output is
    the same bits whatever batch it runs in. ``_core`` / ``_nhwc_core``
    (private): the NCHW / NHWC form's GEMM core forced ('wgmma', 'wmma' or
    ('wgmma', BN, stages)), for timing and checks; it raises where it
    cannot, or where x is in the other layout.
    Differentiable through ``ConvNormAct``."""
    if needs_graph(x, w):
        return ConvNormAct.apply(x, w, eps, activation, split_batch, _core,
                                 _nhwc_core)
    return _forward(x, w, eps, activation, split_batch, _core, _nhwc_core)


conv_norm_act.launches = 0
# the NHWC form's launches alone (``launches`` counts both forms'), and
# the wgmma core's (both forms')
conv_norm_act.launches_nhwc = 0
conv_norm_act.launches_wgmma = 0


# band form


def conv_band_plain(xh, w):
    """(fp32 conv output, its per-plane stats [N, Cout, 2]) of a band xh
    with one halo row above and below: H unpadded, W padded by 1 on both
    sides."""
    acc = F.conv2d(xh.float(), w.float(), stride=2, padding=(0, 1))
    return acc, in_stats_plain(acc)


def conv_band_plan(n, cin, h, w, cout, dtype, split_batch=None,
                   core=None):
    """``nhwc_gemm_plan`` of K2's band form on a haloed band (n, cin, h,
    w), whose output has (h - 4) // 2 + 1 rows. The wgmma core reads the
    layout pass's channels_last copies, fresh allocations on 16 bytes."""
    ho, wo = (h - 4) // 2 + 1, (w - 2) // 2 + 1
    return nhwc_gemm_plan(ho * wo, 1, (cin,), 16, cout, dtype, True,
                          split_batch or n, core)


def nchw_to_nhwc_plain(x):
    """The band entries' layout pass in plain PyTorch: (B, C, ...) ->
    (B, ..., C) contiguous. A test helper; no CUDA path takes it."""
    return x.movedim(1, -1).contiguous()


def nchw_to_nhwc(x):
    """The band entries' layout pass alone on a contiguous CUDA bf16 x
    (B, C, ...): (B, ..., C) contiguous, to hold against
    ``nchw_to_nhwc_plain`` and to time. Not a K2 launch."""
    require(x, 'x', x.dim())
    if x.dtype != torch.bfloat16 or x.dim() < 2:
        raise ValueError(f"the layout pass takes a bf16 tensor of 2 or more "
                         f"dimensions, not {x.dtype} {tuple(x.shape)}")
    y = torch.empty(x.movedim(1, -1).shape, dtype=x.dtype, device=x.device)
    with _build.device_guard(x):
        rc = _lib().pgt_nchw_to_nhwc(x.data_ptr(), y.data_ptr(), x.shape[0],
                                     x.shape[1], x[0, 0].numel(),
                                     _build.stream_of(x))
    _build.check(rc, 'layout pass')
    return y


def _ptr(t):
    return None if t is None else t.data_ptr()


def conv_band(xh, w, split_batch=None, *, _core=None):
    """``conv_band_plain`` for CPU tensors; on CUDA tensors ``pgt_conv_band``
    on the core ``conv_band_plan`` names: the layout pass and the wgmma
    GEMM, or the WMMA GEMM, then the stats. Returns (fp32 output, stats).
    ``_core`` (private): the core forced ('wgmma', 'wmma' or ('wgmma', BN,
    stages)), for timing and checks; it raises where that core cannot run,
    on CPU tensors too."""
    if _core is not None:
        n, cin, h, wd = xh.shape
        conv_band_plan(n, cin, h, wd, w.shape[0], xh.dtype, split_batch,
                       _core)
    if xh.device.type == 'cpu':
        return conv_band_plain(xh, w)
    require(xh, 'x', 4)
    require(w, 'w', 4, like=xh)
    flag = dtype_flag(xh)
    n, cin, h, wd = xh.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 4, 4):
        raise ValueError(f"w must be ({cout}, {cin}, 4, 4), got "
                         f"{tuple(w.shape)}")
    ho, wo = (h - 4) // 2 + 1, (wd - 2) // 2 + 1
    if ho < 1 or wo < 1 or not n:
        raise ValueError(f"band {tuple(xh.shape)} is too small for k=4, "
                         f"s=2")
    require_aligned(w, 'w')
    lib = _lib()
    plan = conv_band_plan(n, cin, h, wd, cout, xh.dtype, split_batch, _core)
    wgmma = plan.core == 'wgmma'
    acc = f32_scratch(plan.splits, n, cout, ho, wo, like=xh)
    part = f32_scratch(n, cout, plan.parts, 2, like=xh)
    stats = f32_scratch(n, cout, 2, like=xh)
    # the layout pass's channels_last copies of the band and the weight
    xt, wt = (torch.empty(t.numel(), dtype=t.dtype, device=t.device)
              if wgmma else None for t in (xh, w))
    with _build.device_guard(xh):
        rc = lib.pgt_conv_band(
            xh.data_ptr(), w.data_ptr(), _ptr(xt), _ptr(wt), acc.data_ptr(),
            part.data_ptr(), stats.data_ptr(), n, split_batch or n, cin, h,
            wd, cout, flag, int(wgmma), plan.bn, plan.stages, plan.splits,
            plan.samples, _build.stream_of(xh))
    _build.check(rc, f'conv_band ({plan.core} core)')
    conv_band.launches += 1
    conv_band.launches_wgmma += wgmma
    return acc[0], stats


conv_band.launches = 0
# of them the wgmma core's
conv_band.launches_wgmma = 0


def recompute_band_grads(ctx, g, conv, inputs, stats):
    """``recompute_grads`` of a band: ``conv(*inputs)`` recomputed on the
    haloed band, K1-bwd's band form (``band_backward``, one sum over the
    spatial group) from the forward's global ``stats``, then the input
    gradients through the recompute; the haloed input's goes on to the
    halo's backward."""
    want = [t is not None and need
            for t, need in zip(inputs, ctx.needs_input_grad)]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(inputs, want)]
        out = conv(*leaves)
    recompute_grads.launches += 1
    dout = band_backward(g.to(out.dtype).contiguous(), out.detach(), stats,
                         ctx.count, ctx.eps, ctx.activation, ctx.axis,
                         ctx.group)
    wanted = [t for t, need in zip(leaves, want) if need]
    found = iter(torch.autograd.grad(out, wanted, dout)) if wanted else None
    return [next(found) if need else None for need in want]


def _conv_band(xh, w):
    return F.conv2d(xh, w, stride=2, padding=(0, 1))


class ConvNormActBand(torch.autograd.Function):
    """K2 over a haloed band: ``conv_band``, the stats' sum over the axis,
    ``in_apply``; backward by ``recompute_band_grads``. Residuals (xh, w,
    the plane's global stats)."""

    @staticmethod
    def forward(ctx, xh, w, eps, activation, split_batch, axis, group, count):
        acc, stats = conv_band(xh, w, split_batch)
        axis.all_reduce(stats, group)
        ctx.save_for_backward(xh, w, stats)
        ctx.eps, ctx.activation = eps, activation
        ctx.axis, ctx.group, ctx.count = axis, group, count
        return in_apply(acc, stats, count, eps, activation, xh.dtype)

    @staticmethod
    def backward(ctx, g):
        xh, w, stats = ctx.saved_tensors
        dxh, dw = recompute_band_grads(ctx, g, _conv_band, (xh, w), stats)
        return dxh, dw, None, None, None, None, None, None


def conv_norm_act_band(xh, w, eps, activation, axis, count,
                       split_batch=None):
    """``conv_norm_act`` of the whole image, on this rank's band with one
    halo row above and below (``SpatialAxis.halo``; zero rows at the
    image's edges): the band's output rows, normalised with the plane's
    statistics summed over the spatial ``axis``; ``count`` is the output
    plane's global element count. Differentiable through
    ``ConvNormActBand``."""
    group = axis.group_now()
    if needs_graph(xh, w):
        return ConvNormActBand.apply(xh, w, eps, activation, split_batch,
                                     axis, group, count)
    acc, stats = conv_band(xh, w, split_batch)
    axis.all_reduce(stats, group)
    return in_apply(acc, stats, count, eps, activation, xh.dtype)
