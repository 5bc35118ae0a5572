"""K3: transposed conv(k=4, s=2, p=1, no bias) over concat(x, skip) +
instance norm + activation, NCHW or NHWC (channels_last), torch IOHW
weight, with its gradient.

Port of ``patchgan_tpu/ops/pallas/convt_norm_act.py::fused_convt_norm_act``.
The CUDA kernel is ``csrc/convt_norm_act.cu``; ``convt_norm_act_plain``
is the same function in plain PyTorch (CPU tensors, tests, and the
kernel's oracle on the card). Each launch first packs the weight per
output parity class, k-contiguous (``pack_convt_weight_plain`` is that
layout in plain PyTorch, ``pack_convt_weight`` the pack kernel alone;
both for tests and ``chip_smoke.py``). ``ConvTNormAct`` is the custom VJP of
``convt_norm_act.py:201-225``: residuals (x, w, skip); the backward
recomputes the transposed conv over the concat in the compute dtype,
runs K1-bwd on it, and takes dx, dw and dskip through the recompute.

Band form (spatial parallelism, ``parallel/spatial.py``): ``convt_band``
takes a rank's NCHW bands of x and skip with one halo row above and below
(zero rows at the image's edges, ``SpatialAxis.halo``) and writes the
fp32 output of the band's own rows (NCHW) and its per-plane stats. Its
core is the planner's (``convt_band_plan``): in bf16 with Cx, Cs and Cout
multiples of 64 the wgmma core, after the layout pass copies both bands
into channels_last scratch and the pack writes the NHWC form's layout
(``pack_convt_weight_nhwc_plain``'s) from the NCHW weight; otherwise the
WMMA core on the NCHW bands. ``_core`` forces one as in ``conv_band``.
``convt_norm_act_band`` (``ConvTNormActBand``) sums the stats over the
spatial group and finishes with ``in_apply``; the backward is
``recompute_band_grads``.

NHWC form: channels_last x, skip and weight (``norm_act.is_nhwc``) launch
``pgt_convt_in_act_nhwc``, whose pack kernel reads the channels_last
weight (``pack_convt_weight_nhwc_plain`` is its layout in plain PyTorch,
``pack_convt_weight_nhwc`` the pack kernel alone), then a GEMM core on an
NHWC problem and the finish of ``csrc/norm_nhwc.cuh``; the output is
channels_last. NCHW-contiguous inputs take the NCHW form,
``pgt_convt_in_act``; anything else raises. Both forms' core is K2's
choice (``conv_norm_act.nhwc_gemm_plan``, here through
``convt_nhwc_plan``): the wgmma core of ``csrc/conv_wgmma.cuh`` in bf16
with Cx, Cs and Cout multiples of 64 and x, skip and w on 16 bytes, else
the WMMA core. On the wgmma core the NCHW form's C call first copies x
and skip into channels_last scratch (the layout pass) and packs the NCHW
weight in the NHWC form's order, as the band form does, and ends in the
stats and ``in_apply``'s kernel writing y in NCHW. ``_core`` and
``_nhwc_core`` force the NCHW and the NHWC form's core as in
``conv_norm_act``; ``convt_norm_act.launches_wgmma`` counts both forms'
launches on the wgmma core.

Unlike the TPU gate (``Cout >= 128``, a lane-padding limit of that chip),
every Cout runs the kernel here, so the nf=64 generator's dec5 (Cout=64)
goes through it too.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .conv_norm_act import (_ptr, forced_core, nhwc_gemm_plan,
                            recompute_band_grads, recompute_grads)
from .norm_act import (_aligned, act_code, dtype_flag, f32_scratch, in_apply,
                       in_stats_plain, instance_norm_act_plain, is_nhwc,
                       needs_graph, nhwc_plan, require, require_aligned)

TILE_K = 32   # BK of csrc/conv_gemm.cuh: the packed rows' multiple


def convt_norm_act_plain(x, w, eps=1e-5, activation=None, skip=None):
    """fp32 transposed conv over the concat of the given values, then the
    fp32 norm and activation, cast back to x's dtype."""
    xin = x if skip is None else torch.cat([x, skip], dim=1)
    acc = F.conv_transpose2d(xin.float(), w.float(), stride=2, padding=1)
    return instance_norm_act_plain(acc, eps, activation).to(x.dtype)


def pack_convt_weight_plain(w):
    """The K3 GEMM's weight: (4, Cout, Kp) with wp[g, co, 4 ci + 2 ay +
    ax] = w[ci, co, 1 - (g >> 1) + 2 ay, 1 - (g & 1) + 2 ax] for output
    parity class g = 2 dy + dx, zero from K = 4 Cin up to Kp, the next
    multiple of ``TILE_K``."""
    cin, cout = w.shape[:2]
    k = 4 * cin
    wp = torch.stack([w[:, :, 1 - (g >> 1)::2, 1 - (g & 1)::2]
                      .permute(1, 0, 2, 3).reshape(cout, k)
                      for g in range(4)])
    return F.pad(wp, (0, -(-k // TILE_K) * TILE_K - k))


def pack_convt_weight_nhwc_plain(w):
    """The NHWC form's packed weight: (4, Cout, Kp) with wp[g, co, (2 ay
    + ax) C + ci] = w[ci, co, 1 - (g >> 1) + 2 ay, 1 - (g & 1) + 2 ax]
    (taps outer, channels inner), zero from K = 4 C up to Kp, the next
    multiple of ``TILE_K``."""
    c, cout = w.shape[:2]
    k = 4 * c
    wp = torch.stack([w[:, :, 1 - (g >> 1)::2, 1 - (g & 1)::2]
                      .permute(1, 2, 3, 0).reshape(cout, k)
                      for g in range(4)])
    return F.pad(wp, (0, -(-k // TILE_K) * TILE_K - k))


def convt_nhwc_plan(n, cx, cs, h, w, cout, dtype, aligned=True,
                    split_batch=None, core=None):
    """``nhwc_gemm_plan`` of K3's whole-plane forms (NHWC, and NCHW,
    whose wgmma core reads the layout pass's channels_last copies) on x
    (n, cx, h, w), a skip of cs channels (0: none) and a (cx + cs, cout, 4,
    4) weight; ``aligned``: x, skip and the weight on 16 bytes."""
    return nhwc_gemm_plan(h * w, 4, (cx, cs), 4, cout, dtype, aligned,
                          split_batch or n, core)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('convt_norm_act')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pgt_convt_in_act.argtypes = [p] * 10 + [i] * 8 + [
        ctypes.c_float] + [i] * 6 + [p]
    lib.pgt_convt_in_act.restype = i
    lib.pgt_convt_pack.argtypes = [p, p, i, i, i, i, p]
    lib.pgt_convt_pack.restype = i
    lib.pgt_convt_packed_k.argtypes = [i, i]
    lib.pgt_convt_packed_k.restype = i
    lib.pgt_convt_band.argtypes = [p] * 9 + [i] * 13 + [p]
    lib.pgt_convt_band.restype = i
    lib.pgt_convt_pack_nhwc.argtypes = [p, p, i, i, i, i, p]
    lib.pgt_convt_pack_nhwc.restype = i
    lib.pgt_convt_in_act_nhwc.argtypes = [p] * 8 + [i] * 8 + [
        ctypes.c_float] + [i] * 9 + [p]
    lib.pgt_convt_in_act_nhwc.restype = i
    return lib


def _packed(lib, w):
    """An empty buffer for w's packed form."""
    return torch.empty((4, w.shape[1], lib.pgt_convt_packed_k(w.shape[0], 0)),
                       dtype=w.dtype, device=w.device)


def pack_convt_weight(w):
    """The pack kernel alone on a CUDA weight (Cin, Cout, 4, 4): what K3
    packs before its GEMM, to hold against ``pack_convt_weight_plain``.
    Not a K3 launch."""
    require(w, 'w', 4)
    if w.shape[2:] != (4, 4):
        raise ValueError(f"w must be (Cin, Cout, 4, 4), got {tuple(w.shape)}")
    require_aligned(w, 'w')
    lib = _lib()
    wp = _packed(lib, w)
    with torch.cuda.device(w.device):
        rc = lib.pgt_convt_pack(w.data_ptr(), wp.data_ptr(), w.shape[0], 0,
                                w.shape[1], dtype_flag(w), _build.stream_of(w))
    _build.check(rc, 'convt pack')
    return wp


def pack_convt_weight_nhwc(w):
    """The NHWC form's pack kernel alone on a channels_last CUDA weight
    (Cin, Cout, 4, 4), to hold against ``pack_convt_weight_nhwc_plain``.
    Not a K3 launch."""
    require(w, 'w', 4, nhwc=True)
    if w.shape[2:] != (4, 4):
        raise ValueError(f"w must be (Cin, Cout, 4, 4), got {tuple(w.shape)}")
    lib = _lib()
    wp = _packed(lib, w)
    with torch.cuda.device(w.device):
        rc = lib.pgt_convt_pack_nhwc(w.data_ptr(), wp.data_ptr(), w.shape[0],
                                     0, w.shape[1], dtype_flag(w),
                                     _build.stream_of(w))
    _build.check(rc, 'convt pack (NHWC)')
    return wp


def _forward(x, w, eps, activation, skip, split_batch=None, core=None,
             nhwc_core=None):
    """K3 on CUDA tensors, the plain version on CPU tensors; never
    recorded by autograd. ``core`` / ``nhwc_core``: the NCHW / NHWC
    form's core forced (checked on CPU tensors too)."""
    forced = forced_core(x, core, nhwc_core)
    if forced is not None:
        n, cx, h, wd = x.shape
        cs = 0 if skip is None else skip.shape[1]
        plan = convt_nhwc_plan(
            n, cx, cs, h, wd, w.shape[1], x.dtype,
            _aligned(x, w, *([] if skip is None else [skip])), split_batch,
            forced)
    if x.device.type == 'cpu':
        return convt_norm_act_plain(x, w, eps, activation, skip)
    act = act_code(activation)
    nhwc = x.dim() == 4 and is_nhwc(x)
    require(x, 'x', 4, nhwc=nhwc)
    require(w, 'w', 4, like=x, nhwc=nhwc)
    n, cx, h, wd = x.shape
    cs = 0
    if skip is not None:
        require(skip, 'skip', 4, like=x, nhwc=nhwc)
        if skip.shape[0] != n or skip.shape[2:] != x.shape[2:]:
            raise ValueError(f"skip {tuple(skip.shape)} does not match x "
                             f"{tuple(x.shape)}")
        cs = skip.shape[1]
    cout = w.shape[1]
    if tuple(w.shape) != (cx + cs, cout, 4, 4):
        raise ValueError(f"w must be ({cx + cs}, {cout}, 4, 4), got "
                         f"{tuple(w.shape)}")
    require_aligned(w, 'w')
    if forced is None:
        plan = convt_nhwc_plan(
            n, cx, cs, h, wd, cout, x.dtype,
            _aligned(x, w, *([] if skip is None else [skip])), split_batch)
    return (_forward_nhwc if nhwc else _forward_nchw)(
        _lib(), x, w, act, eps, skip, split_batch, plan)


def _forward_nchw(lib, x, w, act, eps, skip, split_batch, plan):
    """K3's NCHW form on NCHW-contiguous x, skip and w (checked by
    ``_forward``) on the core ``plan`` (``convt_nhwc_plan``) names: on the
    wgmma core the layout pass's channels_last copies of x and skip, the
    pack, the GEMM, the stats and the apply, one C call."""
    n, cx, h, wd = x.shape
    cs = 0 if skip is None else skip.shape[1]
    cout = w.shape[1]
    y = torch.empty((n, cout, 2 * h, 2 * wd), dtype=x.dtype, device=x.device)
    wgmma = plan.core == 'wgmma'
    # fp32 conv output, one copy per K split
    acc = f32_scratch(plan.splits * y.numel(), like=x)
    part = f32_scratch(n * cout * plan.parts, 2, like=x)
    stats = f32_scratch(n * cout, 2, like=x) if wgmma else None
    wp = _packed(lib, w)
    # the layout pass's channels_last copies of x and skip
    xt, st = (torch.empty(t.numel(), dtype=t.dtype, device=t.device)
              if wgmma and t is not None else None for t in (x, skip))
    with _build.device_guard(x):
        rc = lib.pgt_convt_in_act(
            x.data_ptr(), _ptr(skip), w.data_ptr(), wp.data_ptr(),
            y.data_ptr(), acc.data_ptr(), part.data_ptr(), _ptr(xt),
            _ptr(st), _ptr(stats), n, split_batch or n, cx, cs, h, wd, cout,
            act, eps, dtype_flag(x), int(wgmma), plan.bn, plan.stages,
            plan.splits, plan.samples, _build.stream_of(x))
    _build.check(rc, f'convt_norm_act ({plan.core} core)')
    convt_norm_act.launches += 1
    convt_norm_act.launches_wgmma += wgmma
    return y


def _forward_nhwc(lib, x, w, act, eps, skip, split_batch, plan):
    """K3's NHWC form on channels_last x, skip and w (checked by
    ``_forward``) on the core ``plan`` (``convt_nhwc_plan``) names."""
    n, cx, h, wd = x.shape
    cs = 0 if skip is None else skip.shape[1]
    cout = w.shape[1]
    y = torch.empty((n, cout, 2 * h, 2 * wd), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    acc = f32_scratch(plan.splits * y.numel(), like=x)
    vec, segs = nhwc_plan(n, 4 * h * wd, cout, x.dtype, acc, y)
    part = f32_scratch(n * cout * max(plan.parts, segs), 2, like=x)
    stats = f32_scratch(n * cout, 2, like=x)
    wp = _packed(lib, w)
    skip_ptr = skip.data_ptr() if skip is not None else None
    x_vec = cx % TILE_K == 0 and cs % TILE_K == 0 and x.data_ptr() % 16 == 0 \
        and (skip is None or skip.data_ptr() % 16 == 0)
    wgmma = plan.core == 'wgmma'
    with _build.device_guard(x):
        rc = lib.pgt_convt_in_act_nhwc(
            x.data_ptr(), skip_ptr, w.data_ptr(), wp.data_ptr(),
            y.data_ptr(), acc.data_ptr(), part.data_ptr(), stats.data_ptr(),
            n, split_batch or n, cx, cs, h, wd, cout, act, eps,
            dtype_flag(x), int(x_vec), int(vec), segs, int(wgmma), plan.bn,
            plan.stages, plan.splits, plan.samples, _build.stream_of(x))
    _build.check(rc, f'convt_norm_act (NHWC, {plan.core} core)')
    convt_norm_act.launches += 1
    convt_norm_act.launches_nhwc += 1
    convt_norm_act.launches_wgmma += wgmma
    return y


def _convt(x, w, skip):
    xin = x if skip is None else torch.cat([x, skip], dim=1)
    return F.conv_transpose2d(xin, w, stride=2, padding=1)


class ConvTNormAct(torch.autograd.Function):
    """K3 forward; backward by recompute + K1-bwd. Residuals (x, w,
    skip)."""

    @staticmethod
    def forward(ctx, x, w, skip, eps, activation, split_batch, core,
                nhwc_core):
        ctx.save_for_backward(x, w, skip)
        ctx.eps, ctx.activation = eps, activation
        return _forward(x, w, eps, activation, skip, split_batch, core,
                        nhwc_core)

    @staticmethod
    def backward(ctx, g):
        x, w, skip = ctx.saved_tensors
        dx, dw, dskip = recompute_grads(ctx, g, _convt, (x, w, skip))
        return dx, dw, dskip, None, None, None, None, None


def convt_norm_act(x, w, eps=1e-5, activation=None, skip=None,
                   split_batch=None, *, _core=None, _nhwc_core=None):
    """x: (N, Cx, H, W), optional skip: (N, Cs, H, W), w: (Cx + Cs, Cout,
    4, 4), all in x's dtype and layout (NCHW-contiguous, or all
    channels_last). Returns (N, Cout, 2H, 2W) in that layout. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel in the form
    of its layout. ``split_batch``, ``_core`` and ``_nhwc_core`` (private)
    as in ``conv_norm_act``. Differentiable through ``ConvTNormAct``."""
    if needs_graph(x, w, skip):
        return ConvTNormAct.apply(x, w, skip, eps, activation, split_batch,
                                  _core, _nhwc_core)
    return _forward(x, w, eps, activation, skip, split_batch, _core,
                    _nhwc_core)


convt_norm_act.launches = 0
# the NHWC form's launches alone (``launches`` counts both forms'), and
# the wgmma core's (both forms')
convt_norm_act.launches_nhwc = 0
convt_norm_act.launches_wgmma = 0


# band form


def convt_band_plain(xh, w, skip=None):
    """(fp32 output, its per-plane stats [N, Cout, 2]) of the transposed
    conv over the bands of x and skip, each with one halo row above and
    below: the band's own 2 * (h - 2) rows."""
    xin = xh if skip is None else torch.cat([xh, skip], dim=1)
    acc = F.conv_transpose2d(xin.float(), w.float(), stride=2,
                             padding=(3, 1))
    return acc, in_stats_plain(acc)


def convt_band_plan(n, cx, cs, h, w, cout, dtype, split_batch=None,
                    core=None):
    """``nhwc_gemm_plan`` of K3's band form on haloed bands of x (n, cx, h,
    w) and a skip of cs channels (0: none): h - 2 class rows. The wgmma
    core reads the layout pass's channels_last copies, fresh allocations
    on 16 bytes."""
    return nhwc_gemm_plan((h - 2) * w, 4, (cx, cs), 4, cout, dtype, True,
                          split_batch or n, core)


def convt_band(xh, w, skip=None, split_batch=None, *, _core=None):
    """``convt_band_plain`` for CPU tensors; on CUDA tensors
    ``pgt_convt_band`` on the core ``convt_band_plan`` names: the layout
    passes, the pack and the wgmma GEMM, or the pack and the WMMA GEMM,
    then the stats. Returns (fp32 output, stats). ``_core`` (private) as
    in ``conv_band``."""
    if _core is not None:
        n, cx, h, wd = xh.shape
        convt_band_plan(n, cx, 0 if skip is None else skip.shape[1], h, wd,
                        w.shape[1], xh.dtype, split_batch, _core)
    if xh.device.type == 'cpu':
        return convt_band_plain(xh, w, skip)
    require(xh, 'x', 4)
    require(w, 'w', 4, like=xh)
    n, cx, h, wd = xh.shape
    cs = 0
    if skip is not None:
        require(skip, 'skip', 4, like=xh)
        if skip.shape[0] != n or skip.shape[2:] != xh.shape[2:]:
            raise ValueError(f"skip {tuple(skip.shape)} does not match x "
                             f"{tuple(xh.shape)}")
        cs = skip.shape[1]
    flag = dtype_flag(xh)
    cout = w.shape[1]
    if tuple(w.shape) != (cx + cs, cout, 4, 4):
        raise ValueError(f"w must be ({cx + cs}, {cout}, 4, 4), got "
                         f"{tuple(w.shape)}")
    hc = h - 2
    if hc < 1 or not n:
        raise ValueError(f"band {tuple(xh.shape)} has no output rows")
    require_aligned(w, 'w')
    lib = _lib()
    plan = convt_band_plan(n, cx, cs, h, wd, cout, xh.dtype, split_batch,
                           _core)
    wgmma = plan.core == 'wgmma'
    acc = f32_scratch(plan.splits, n, cout, 2 * hc, 2 * wd, like=xh)
    part = f32_scratch(n, cout, plan.parts, 2, like=xh)
    stats = f32_scratch(n, cout, 2, like=xh)
    wp = _packed(lib, w)
    # the layout pass's channels_last copies of the bands
    xt, st = (torch.empty(t.numel(), dtype=t.dtype, device=t.device)
              if wgmma and t is not None else None for t in (xh, skip))
    with _build.device_guard(xh):
        rc = lib.pgt_convt_band(
            xh.data_ptr(), _ptr(skip), w.data_ptr(), wp.data_ptr(),
            _ptr(xt), _ptr(st), acc.data_ptr(), part.data_ptr(),
            stats.data_ptr(), n, split_batch or n, cx, cs, h, wd, cout, flag,
            int(wgmma), plan.bn, plan.stages, plan.splits, plan.samples,
            _build.stream_of(xh))
    _build.check(rc, f'convt_band ({plan.core} core)')
    convt_band.launches += 1
    convt_band.launches_wgmma += wgmma
    return acc[0], stats


convt_band.launches = 0
# of them the wgmma core's
convt_band.launches_wgmma = 0


def _convt_band(xh, w, skip):
    xin = xh if skip is None else torch.cat([xh, skip], dim=1)
    return F.conv_transpose2d(xin, w, stride=2, padding=(3, 1))


class ConvTNormActBand(torch.autograd.Function):
    """K3 over haloed bands: ``convt_band``, the stats' sum over the axis,
    ``in_apply``; backward by ``recompute_band_grads``. Residuals (xh, w,
    skip, the plane's global stats)."""

    @staticmethod
    def forward(ctx, xh, w, skip, eps, activation, split_batch, axis, group,
                count):
        acc, stats = convt_band(xh, w, skip, split_batch)
        axis.all_reduce(stats, group)
        ctx.save_for_backward(xh, w, skip, stats)
        ctx.eps, ctx.activation = eps, activation
        ctx.axis, ctx.group, ctx.count = axis, group, count
        return in_apply(acc, stats, count, eps, activation, xh.dtype)

    @staticmethod
    def backward(ctx, g):
        xh, w, skip, stats = ctx.saved_tensors
        dxh, dw, dskip = recompute_band_grads(ctx, g, _convt_band,
                                              (xh, w, skip), stats)
        return dxh, dw, dskip, None, None, None, None, None, None


def convt_norm_act_band(xh, w, eps, activation, axis, count, skip=None,
                        split_batch=None):
    """``convt_norm_act`` of the whole image, on this rank's bands of x and
    skip with one halo row above and below each (``SpatialAxis.halo``): the
    band's 2h output rows, normalised with the plane's statistics summed
    over the spatial ``axis``; ``count`` is the output plane's global
    element count. Differentiable through ``ConvTNormActBand``."""
    group = axis.group_now()
    if needs_graph(xh, w, skip):
        return ConvTNormActBand.apply(xh, w, skip, eps, activation,
                                      split_batch, axis, group, count)
    acc, stats = convt_band(xh, w, skip, split_batch)
    axis.all_reduce(stats, group)
    return in_apply(acc, stats, count, eps, activation, xh.dtype)
