#!/usr/bin/env python3
"""Time versions of the instance-norm kernels K1 and K1-bwd on one CUDA
card, in their NCHW and NHWC (channels_last) forms, each version in its
own process, in turns.

    python3 tools/norm_act_variants.py NAME=CHECKOUT ... [--sweep]

Each NAME=CHECKOUT is a checkout of this repository (``.`` for the
working tree; another revision unpacked with ``git archive`` into an
ignored directory such as ``chip_scratch/``). Its own
``patchgan_tpu_torch`` is imported in a child process, which builds the
kernels from that checkout's sources and, in the order given and then
reversed:

- holds K1-bwd at the 12 shapes of one generator backward (batch 16,
  256 px, nf=64) and K1 at enc0 (the 8-tile inference chunk and the
  batch-16 step) against their plain versions in bf16 and fp32, in both
  layouts where the version has the NHWC form;
- in the NHWC form, takes each kernel the version can be made to launch
  (the wrappers' private ``_nhwc_kernel`` argument: ``one_pass`` and
  ``segmented``), or the one it launches where it has no such argument
  (``nhwc``), as a kind of its own (``K1-bwd NHWC one_pass`` ...);
- times each call in bf16 four ways: ``cuda_ms``, CUDA events around 20
  back-to-back wrapper calls (as ``chip_smoke.py`` does); ``device_ms``,
  the kernels' own durations in a ``torch.profiler`` trace of 20 calls;
  ``graph_ms``, CUDA events around the replay of a CUDA graph of 20
  calls (no host work, launch gaps on the card included); and
  ``host_us``, the host's time to enqueue one call;
- splits the wrapper's host work at the smallest level into the output
  allocation, the device guard, the stream lookup and the rest (the
  ctypes call and the checks);
- prints the bytes bound beside each row, and the launch geometry where
  the version chooses one in Python (``plane_geometry``).

``--sweep`` also times, for each version that has ``plane_geometry``,
every level under each ``per_thread`` it can be given (the chunks a
thread holds, which sets the threads on a plane), and, for each version
that has ``nhwc_one_pass_plan``, the one-pass NHWC kernels at every
(lanes, cluster) geometry their C entry points take (by a CUDA graph's
replay, the planner's choice marked), so that the thresholds can be set
from one call.

It prints the card's name and power limit and, per version and kind,
the mean of its two turns and the sum over the 12 K1-bwd calls.

    python3 tools/norm_act_variants.py --band NAME=CHECKOUT ... [--check]
                                       [--sweep]

``--band`` takes the band forms of K1 and K1-bwd instead (spatial
parallelism: ``in_stats``, ``in_apply``, ``in_bwd_sums``,
``in_bwd_apply``) at the levels of ``chip_smoke.py`` 17a's timed band,
the top band at sp 2 of a 1024-px image at batch 2 (nf=64): ``in_stats``
at enc0, ``in_apply`` on enc0's bf16 band and on the fp32 output of
K2's / K3's band form at enc1-enc6 and dec1-dec5 (into bf16), and
``in_bwd_sums`` / ``in_bwd_apply`` on bf16 g and x at every level's
output band. In its first turn each version holds every entry against its
plain version at every level in bf16 and fp32 (sums within 3e-2 / 1e-3 of
max(1, max |sum|)), at element-path shapes (planes whose bytes are no
multiple of 16, inputs one element past 16 bytes) and in all four
activations, and two launches on the same inputs bit-equal; then it times
each entry in bf16 by ``cuda_ms`` (events around 20 eager calls, the
host's share included) and ``graph_ms`` (a CUDA graph's replay) beside
the bytes bound (HBM_BYTES). It prints each entry's sums over the levels
(mean of the two turns) and, for each level, every version's graph_ms
over the first's. ``--check``: the checks alone, one turn (a short first
call after a change to the kernels). ``--sweep``, for a version that has
``band_sums_plan`` / ``band_bwd_apply_plan``: ``in_bwd_sums`` at every
cluster size its C entry takes where the plan splits a plane, and
``in_bwd_apply`` at every unroll, by graph_ms, the planner's marked.
"""
import functools
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES = 3.35e12
PEAK_FP32 = 67e12
BWD_FLOPS, FWD_FLOPS = 14, 6          # fp32 operations per element
ITERS = 20
SWEEP_PER_THREAD = (1, 2, 4, 8)


def levels():
    """(label, (N, C, H, W)) of the 12 K1-bwd calls of one generator
    backward at batch 16, 256 px, nf=64 (``chip_smoke.bwd_shapes``)."""
    b, f = 16, 64
    out = [('enc0', (b, f, 128, 128))]
    for lvl, (c, hw) in enumerate([(2 * f, 64), (4 * f, 32), (8 * f, 16),
                                   (8 * f, 8), (8 * f, 4), (8 * f, 2)], 1):
        out.append((f'enc{lvl}', (b, c, hw, hw)))
    for lvl, (c, hw) in enumerate([(8 * f, 8), (8 * f, 16), (4 * f, 32),
                                   (2 * f, 64), (f, 128)], 1):
        out.append((f'dec{lvl}', (b, c, hw, hw)))
    return out


FWD_CASES = [('K1 enc0 infer chunk', (8, 64, 128, 128)),
             ('K1 enc0 step', (16, 64, 128, 128))]


def bound_ms(flops, nbytes):
    return max(flops / PEAK_FP32, nbytes / HBM_BYTES) * 1e3


def cuda_ms(torch, fn):
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(ITERS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / ITERS


def device_ms(torch, fn):
    """Kernel time per call from a profiler trace of ITERS calls: the
    entries with device time and no host time of their own."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.self_device_time_total > 0 and e.self_cpu_time_total == 0)
    return us / ITERS / 1e3


def graph_ms(torch, fn):
    """CUDA events around the replay of a graph of ITERS calls."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(ITERS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (5 * ITERS)


def host_us(torch, fn, n=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def host_split(torch, na, x, g):
    """Host microseconds of the wrapper's parts at one call."""
    from patchgan_tpu_torch.ops.kernels import _build
    n = 2000

    def each(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def guard():     # the guard the version's wrapper takes
        with (_build.device_guard(x) if hasattr(_build, 'device_guard')
              else torch.cuda.device(x.device)):
            pass
    parts = {'empty_like_us': each(lambda: torch.empty_like(x)),
             'device_guard_us': each(guard),
             'stream_of_us': each(lambda: _build.stream_of(x)),
             'wrapper_us': host_us(torch, lambda: na.instance_norm_act_backward(
                 g, x, 1e-5, 'relu'), n)}
    if hasattr(na, 'plane_geometry'):
        parts['plane_geometry_us'] = each(lambda: na.plane_geometry(
            x.shape[0] * x.shape[1], x.shape[2] * x.shape[3], x.dtype))
    parts['rest_us'] = parts['wrapper_us'] - sum(
        v for k, v in parts.items() if k != 'wrapper_us')
    return parts


def geometry(na, shape, dtype):
    if not hasattr(na, 'plane_geometry'):
        return {}
    n, c, h, w = shape
    return na.plane_geometry(n * c, h * w, dtype)._asdict()


def nhwc_kernels(na):
    """The NHWC kernels a version can be told to launch: (kind suffix,
    wrapper keyword arguments); none before the NHWC form existed."""
    if not hasattr(na, '_backward_nhwc'):
        return []
    if '_nhwc_kernel' in inspect.signature(
            na.instance_norm_act_backward).parameters:
        return [(k, {'_nhwc_kernel': k}) for k in ('one_pass', 'segmented')]
    return [('nhwc', {})]


def run_child(checkout, name, rep, sweep):
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    from patchgan_tpu_torch.ops.kernels import _build
    from patchgan_tpu_torch.ops.kernels import norm_act as na
    _build.build(('norm_act', 'norm_act_bwd'))
    for lib, log in _build.build_log.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print(f'  ptxas {lib}: {line.strip()}', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(3)
    ok = True

    def emit(row):
        row.update(version=name, rep=rep)
        print(json.dumps(row), flush=True)

    def check(label, fn, plain, args, tol):
        nonlocal ok
        for dt, t in ((torch.bfloat16, tol[0]), (torch.float32, tol[1])):
            a = [v.to(dt) for v in args]
            got = fn(*a, 1e-5, 'relu').float()
            want = plain(*[v.float() for v in a], 1e-5, 'relu')
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            lim = t * max(1.0, want.abs().max().item())
            if not e <= lim:
                ok = False
                print(f'  {name} {label} {dt}: {e} > {lim}  FAIL',
                      flush=True)

    def timed(kind, label, shape, fn, flops, nbytes, extra=None):
        row = {'kernel': kind, 'case': label, 'shape': shape,
               'cuda_ms': cuda_ms(torch, fn),
               'device_ms': device_ms(torch, fn),
               'graph_ms': graph_ms(torch, fn),
               'host_us': host_us(torch, fn),
               'bound_ms': bound_ms(flops, nbytes)}
        row.update(extra or {})
        emit(row)

    def cl(t):
        return t.contiguous(memory_format=torch.channels_last)

    forms = nhwc_kernels(na)
    data = {}
    for label, shape in levels():
        x = torch.randn(*shape, generator=gen, device='cuda')
        g = torch.randn(*shape, generator=gen, device='cuda')
        data[label] = (x, g)
        if rep == 0:
            check(label, na.instance_norm_act_backward,
                  na.instance_norm_act_backward_plain, (g, x), (3e-2, 1e-3))
            for kind, kw in forms:
                check(f'{label} NHWC {kind}', functools.partial(
                    na.instance_norm_act_backward, **kw),
                    na.instance_norm_act_backward_plain, (cl(g), cl(x)),
                    (3e-2, 1e-3))
    for label, shape in FWD_CASES:
        x = torch.randn(*shape, generator=gen, device='cuda')
        data[label] = (x,)
        if rep == 0:
            check(label, na.instance_norm_act, na.instance_norm_act_plain,
                  (x,), (3e-2, 1e-3))
            for kind, kw in forms:
                check(f'{label} NHWC {kind}', functools.partial(
                    na.instance_norm_act, **kw), na.instance_norm_act_plain,
                    (cl(x),), (3e-2, 1e-3))
    with torch.inference_mode():
        for label, shape in levels():
            x, g = (t.bfloat16() for t in data[label])
            numel = x.numel()
            timed('K1-bwd', label, shape,
                  lambda: na.instance_norm_act_backward(g, x, 1e-5, 'relu'),
                  BWD_FLOPS * numel, 6 * numel,
                  {'geometry': geometry(na, shape, torch.bfloat16)})
        for label, shape in FWD_CASES:
            x = data[label][0].bfloat16()
            numel = x.numel()
            timed('K1', label, shape,
                  lambda: na.instance_norm_act(x, 1e-5, 'relu'),
                  FWD_FLOPS * numel, 4 * numel,
                  {'geometry': geometry(na, shape, torch.bfloat16)})
        for kind, kw in forms:
            for label, shape in levels():
                x, g = (cl(t.bfloat16()) for t in data[label])
                timed(f'K1-bwd NHWC {kind}', label, shape,
                      lambda: na.instance_norm_act_backward(
                          g, x, 1e-5, 'relu', **kw),
                      BWD_FLOPS * x.numel(), 6 * x.numel())
            for label, shape in FWD_CASES:
                x = cl(data[label][0].bfloat16())
                timed(f'K1 NHWC {kind}', label, shape,
                      lambda: na.instance_norm_act(x, 1e-5, 'relu', **kw),
                      FWD_FLOPS * x.numel(), 4 * x.numel())
        x, g = (t.bfloat16() for t in data['enc6'])
        emit({'kernel': 'K1-bwd', 'case': 'host split enc6',
              **host_split(torch, na, x, g)})
        if sweep and hasattr(na, 'plane_geometry'):
            chosen = na.plane_geometry
            cases = [('K1-bwd', label, shape) for label, shape in levels()] \
                + [('K1', label, shape) for label, shape in FWD_CASES]
            for kind, label, shape in cases:
                x = data[label][0].bfloat16()
                g = data[label][1].bfloat16() if kind == 'K1-bwd' else None
                seen = set()
                for pt in SWEEP_PER_THREAD:
                    na.plane_geometry = functools.partial(chosen,
                                                          per_thread=pt)
                    geo = geometry(na, shape, torch.bfloat16)
                    key = tuple(sorted(geo.items()))
                    if key in seen:
                        continue
                    seen.add(key)
                    if kind == 'K1-bwd':
                        def fn():
                            return na.instance_norm_act_backward(
                                g, x, 1e-5, 'relu')
                    else:
                        def fn():
                            return na.instance_norm_act(x, 1e-5, 'relu')
                    emit({'kernel': kind, 'case': f'sweep {label}',
                          'per_thread': pt, 'geometry': geo,
                          'device_ms': device_ms(torch, fn),
                          'graph_ms': graph_ms(torch, fn)})
                na.plane_geometry = chosen
        if sweep and hasattr(na, 'nhwc_one_pass_plan'):
            one_pass_sweep(torch, na, data, cl, emit)
    return ok


def one_pass_sweep(torch, na, data, cl, emit):
    """K1-bwd at the 12 levels and K1 at enc0, NHWC, bf16, relu, through
    the one-pass C entry points at every (lanes, cluster) whose shared
    memory fits a block: graph_ms each, ``planned`` where
    ``nhwc_one_pass_plan`` picks it."""
    cases = [('K1-bwd', label, shape) for label, shape in levels()] + \
        [('K1', label, shape) for label, shape in FWD_CASES]
    for kind, label, shape in cases:
        n, c, h, w = shape
        hw, inputs = h * w, 2 if kind == 'K1-bwd' else 1
        x = cl(data[label][0].bfloat16())
        g = cl(data[label][1].bfloat16()) if inputs == 2 else None
        y = torch.empty_like(x)
        plan = na.nhwc_one_pass_plan(n, hw, c, torch.bfloat16, inputs)
        for lanes in (1, 2, 4, 8, 16, 32):
            for cluster in (1, 2, 4, 8):
                if c % (lanes * 8) or na.one_pass_smem(
                        lanes * 8, cluster, -(-hw // cluster), lanes * 16,
                        inputs) > na.SMEM_PER_BLOCK:
                    continue

                def fn(lanes=lanes, cluster=cluster):
                    st = torch.cuda.current_stream().cuda_stream
                    if g is None:
                        return na._lib().pgt_in_act_nhwc_one_pass(
                            x.data_ptr(), y.data_ptr(), n, hw, c, 2, 1e-5,
                            1, lanes, cluster, st)
                    return na._bwd_lib().pgt_in_act_bwd_nhwc_one_pass(
                        g.data_ptr(), x.data_ptr(), y.data_ptr(), n, hw, c,
                        2, 1e-5, 1, lanes, cluster, st)

                rc = fn()
                torch.cuda.synchronize()
                emit({'kernel': f'{kind} NHWC one_pass sweep', 'case': label,
                      'lanes': lanes, 'cluster': cluster,
                      'ctas': cluster * (c // (lanes * 8)) * n, 'rc': rc,
                      'graph_ms': graph_ms(torch, fn) if rc == 0 else None,
                      'planned': plan is not None and
                      (plan.lanes, plan.cluster) == (lanes, cluster)})


# --band: the band entries at 17a's top band (chip_smoke.py SP_BANDS[0])
BAND_SIZE, BAND_B, BAND_SP, NF = 1024, 2, 2, 64
ACTS = (None, 'tanh', 'relu', 'leakyrelu')


def band_levels():
    """(label, whole output (N, C, H, W), the dtype ``in_apply`` reads):
    the nf=64 generator's normed levels at BAND_SIZE px (``chip_smoke.
    sp_levels``); enc0's apply reads K1's bf16 input, the others the fp32
    output of K2's / K3's band form."""
    b, f = BAND_B, NF
    filts = [f, 2 * f, 4 * f, 8 * f, 8 * f, 8 * f, 8 * f]
    out = [(f'enc{i}', (b, filts[i], BAND_SIZE >> (i + 1),
                        BAND_SIZE >> (i + 1)), 'fp32' if i else 'bf16')
           for i in range(7)]
    for lvl, c in enumerate((8 * f, 8 * f, 4 * f, 2 * f, f), 1):
        hw = BAND_SIZE >> (6 - lvl)
        out.append((f'dec{lvl}', (b, c, hw, hw), 'fp32'))
    return out


def band_child(checkout, name, rep, mode):
    """One version's turn of ``--band``: checks (first turn or --check),
    timing rows (unless --check), the sweep (first turn of --sweep)."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    from patchgan_tpu_torch.ops.kernels import _build
    from patchgan_tpu_torch.ops.kernels import norm_act as na
    _build.build(('norm_act', 'norm_act_bwd'))
    for lib, log in _build.build_log.items():
        keep = False
        for line in log.splitlines():
            if 'Compiling' in line:
                keep = 'band' in line
            if keep and ('registers' in line or 'spill' in line
                         or 'Compiling' in line):
                print(f'  ptxas {lib}: {line.strip()}', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(24)
    eps, act = 1e-5, 'relu'
    ok = True

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device='cuda')

    def emit(row):
        row.update(version=name, rep=rep)
        print(json.dumps(row), flush=True)

    def close(label, got, want, tol):
        nonlocal ok
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        lim = tol * max(1.0, want.float().abs().max().item())
        if not e <= lim:
            ok = False
            print(f'  {name} {label}: {e} > {lim}  FAIL', flush=True)

    def same_bits(label, fn):
        nonlocal ok
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            ok = False
            print(f'  {name} {label}: two launches differ  FAIL', flush=True)

    def check_band(label, make, st, count, act, bits=False):
        """Every entry on the band ``make(dtype)`` gives as (x, g), in bf16
        and fp32, against its plain version; ``st`` the planes' global
        stats."""
        x32 = make(torch.float32)[0]
        for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-3)):
            xd, gd = make(dt)
            xf, gf = xd.float(), gd.float()
            close(f'{label} in_stats {dt}', na.in_stats(xd),
                  na.in_stats_plain(xf), tol)
            for src in (xd, x32):
                close(f'{label} in_apply {src.dtype} -> {dt}',
                      na.in_apply(src, st, count, eps, act, dt),
                      na.in_apply_plain(src.float(), st, count, eps, act),
                      tol)
            u = na.in_bwd_sums(gd, xd, st, count, eps, act)
            close(f'{label} in_bwd_sums {dt}', u,
                  na.in_bwd_sums_plain(gf, xf, st, count, eps, act), tol)
            close(f'{label} in_bwd_apply {dt}',
                  na.in_bwd_apply(gd, xd, st, u, count, eps, act),
                  na.in_bwd_apply_plain(gf, xf, st, u, count, eps, act),
                  tol)
            if bits:
                same_bits(f'{label} in_bwd_sums {dt}', lambda: na.in_bwd_sums(
                    gd, xd, st, count, eps, act))
                same_bits(f'{label} in_apply {dt}', lambda: na.in_apply(
                    x32, st, count, eps, act, dt))

    def same(x, g):
        return lambda dt: (x.to(dt), g.to(dt))

    def top(t):
        return t[:, :, :t.shape[2] // BAND_SP].contiguous()

    data = []
    for label, shape, src in band_levels():
        x, g = rand(*shape), rand(*shape)
        st = na.in_stats_plain(x)
        count = shape[2] * shape[3]
        data.append((label, top(x), top(g), st, count, src))
    if rep == 0 or mode == 'check':
        for label, x, g, st, count, _ in data:
            check_band(label, same(x, g), st, count, act, bits=True)
        # element paths: planes of 15 and 8643 elements (no multiple of
        # 16 bytes), x and g one element past 16 bytes; every activation
        for shape in ((2, 8, 3, 5), (1, 4, 67, 129), (2, 16, 8, 8),
                      (1, 2, 128, 256)):
            x, g = rand(*shape), rand(*shape)
            count = 2 * shape[2] * shape[3]
            st = na.in_stats_plain(x) * 2
            for a in ACTS:
                check_band(f'{shape} {a}', same(x, g), st, count, a)
            xo, go = rand(x.numel() + 1), rand(x.numel() + 1)
            check_band(f'{shape} one element past 16 bytes',
                       lambda dt: (xo.to(dt)[1:].view(shape),
                                   go.to(dt)[1:].view(shape)), st, count,
                       act, bits=True)
    if mode == 'check':
        return ok
    with torch.inference_mode():
        for label, x, g, st, count, src in data:
            xb, gb = x.bfloat16(), g.bfloat16()
            a_in = xb if src == 'bf16' else x
            u = na.in_bwd_sums(gb, xb, st, count, eps, act)
            numel = x.numel()
            cases = [('in_apply', lambda: na.in_apply(
                a_in, st, count, eps, act, torch.bfloat16),
                numel * (a_in.element_size() + 2)),
                ('in_bwd_sums', lambda: na.in_bwd_sums(
                    gb, xb, st, count, eps, act), 4 * numel),
                ('in_bwd_apply', lambda: na.in_bwd_apply(
                    gb, xb, st, u, count, eps, act), 6 * numel)]
            if label == 'enc0':
                cases.insert(0, ('in_stats', lambda: na.in_stats(xb),
                                 2 * numel))
            for kind, fn, nbytes in cases:
                geo = {}
                if kind == 'in_bwd_sums' and hasattr(na, 'band_sums_plan'):
                    geo = na.band_sums_plan(x.shape[0] * x.shape[1],
                                            x.shape[2] * x.shape[3],
                                            torch.bfloat16)._asdict()
                if kind == 'in_bwd_apply' and \
                        hasattr(na, 'band_bwd_apply_plan'):
                    geo = na.band_bwd_apply_plan(
                        x.shape[0] * x.shape[1], x.shape[2] * x.shape[3],
                        torch.bfloat16)._asdict()
                emit({'kernel': kind, 'case': label,
                      'shape': list(x.shape), 'cuda_ms': cuda_ms(torch, fn),
                      'graph_ms': graph_ms(torch, fn),
                      'bound_ms': bound_ms(0, nbytes), 'geometry': geo})
        if mode == 'sweep' and hasattr(na, 'band_sums_plan'):
            band_sweep(torch, na, data, emit)
    return ok


def band_sweep(torch, na, data, emit):
    """in_bwd_sums at each cluster size (1, 2, 4, 8) where the plan splits
    a plane, and in_bwd_apply at each unroll (1, 2, 4), bf16, relu,
    through the C entry points (on the stream current at each call, so a
    graph's capture takes them); graph_ms each, ``planned`` where the
    planner picks it."""
    for label, x, g, st, count, _ in data:
        xb, gb = x.bfloat16(), g.bfloat16()
        planes, plane = x.shape[0] * x.shape[1], x.shape[2] * x.shape[3]
        plan = na.band_sums_plan(planes, plane, torch.bfloat16)
        sums = na.in_bwd_sums(gb, xb, st, count, 1e-5, 'relu')
        out = torch.empty(planes, 2, device='cuda')
        if plan.cluster:
            for k in (1, 2, 4, 8):
                def fn(k=k):
                    return na._band_bwd_lib().pgt_in_bwd_sums(
                        gb.data_ptr(), xb.data_ptr(), st.data_ptr(),
                        out.data_ptr(), planes, plane, float(count), 2,
                        1e-5, 1, 1, plan.group, plan.per_thread,
                        plan.threads, k,
                        torch.cuda.current_stream().cuda_stream)
                emit({'kernel': 'in_bwd_sums sweep', 'case': label,
                      'cluster': k, 'rc': fn(),
                      'graph_ms': graph_ms(torch, fn),
                      'planned': k == plan.cluster})
        dx = torch.empty_like(gb)
        dplan = na.band_bwd_apply_plan(planes, plane, torch.bfloat16)
        n = planes * plane // dplan.width
        for unroll in (1, 2, 4):
            grid = min(-(-n // (na.BAND_THREADS * unroll)),
                       na.DX_BLOCKS_MAX)

            def fn(unroll=unroll, grid=grid):
                return na._band_bwd_lib().pgt_in_bwd_apply(
                    gb.data_ptr(), xb.data_ptr(), st.data_ptr(),
                    sums.data_ptr(), dx.data_ptr(), planes, plane,
                    float(count), 2, 1e-5, 1, int(dplan.vec), unroll, grid,
                    torch.cuda.current_stream().cuda_stream)
            emit({'kernel': 'in_bwd_apply sweep', 'case': label,
                  'unroll': unroll, 'grid': grid, 'rc': fn(),
                  'graph_ms': graph_ms(torch, fn),
                  'planned': unroll == dplan.unroll})


def band_main(specs, check, sweep):
    """--band: each version in turns (the order given, then reversed;
    one turn with --check)."""
    rows, ok = [], True
    reps = 1 if check else 2
    for rep in range(reps):
        for name, checkout in (specs if rep == 0 else specs[::-1]):
            mode = 'check' if check else \
                'sweep' if sweep and rep == 0 else 'time'
            t0 = time.time()
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--band-child',
                 checkout, name, str(rep), mode],
                capture_output=True, text=True, cwd=ROOT)
            print(f'== {name} turn {rep} ({time.time() - t0:.1f} s, rc '
                  f'{out.returncode})', flush=True)
            print(out.stdout + out.stderr[-3000:], flush=True)
            ok &= out.returncode == 0
            rows += [json.loads(line) for line in out.stdout.splitlines()
                     if line.startswith('{')]
    if check:
        return ok
    labels = [label for label, _, _ in band_levels()]
    kinds = ('in_stats', 'in_apply', 'in_bwd_sums', 'in_bwd_apply')

    def mean(name, kind, label, key):
        rs = [r[key] for r in rows if r['version'] == name
              and r['kernel'] == kind and r['case'] == label]
        return sum(rs) / len(rs) if rs else None

    print('band entries over the levels, bf16, mean of the two turns '
          '(cuda_ms / graph_ms; bound_ms):')
    for name, _ in specs:
        for kind in kinds:
            tot = [0.0, 0.0, 0.0]
            for label in labels:
                m = [mean(name, kind, label, k)
                     for k in ('cuda_ms', 'graph_ms', 'bound_ms')]
                if m[0] is None:
                    continue
                tot = [t + v for t, v in zip(tot, m)]
                print(f'  {name} {kind} {label}: {m[0]:.4f} / {m[1]:.4f}; '
                      f'{m[2]:.4f}')
            print(f'  {name} {kind}, summed: {tot[0]:.4f} / {tot[1]:.4f}; '
                  f'{tot[2]:.4f}', flush=True)
    if len(specs) > 1:
        first = specs[0][0]
        print(f'graph_ms over {first}\'s, by level:')
        for name, _ in specs[1:]:
            for kind in kinds:
                for label in labels:
                    a = mean(first, kind, label, 'graph_ms')
                    b = mean(name, kind, label, 'graph_ms')
                    if a and b:
                        print(f'  {name} {kind} {label}: {b / a:.3f}')
    swept = [r for r in rows if r['kernel'].endswith(' sweep')]
    for r in swept:
        geo = {k: r[k] for k in ('cluster', 'unroll', 'grid') if k in r}
        print(f'  sweep {r["version"]} {r["kernel"]} {r["case"]}: {geo} '
              f'{r["graph_ms"]:.4f}{" *" if r["planned"] else ""}')
    return ok


def main():
    args = sys.argv[1:]
    if args and args[0] == '--child':
        ok = run_child(args[1], args[2], int(args[3]), args[4] == 'sweep')
        return 0 if ok else 1
    if args and args[0] == '--band-child':
        ok = band_child(args[1], args[2], int(args[3]), args[4])
        return 0 if ok else 1
    sweep = '--sweep' in args
    specs = [a.split('=', 1) for a in args if '=' in a]
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    if '--band' in args:
        return 0 if band_main(specs, '--check' in args, sweep) else 1
    rows, ok = [], True
    for rep in range(2):
        for name, checkout in (specs if rep == 0 else specs[::-1]):
            t0 = time.time()
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--child',
                 checkout, name, str(rep),
                 'sweep' if sweep and rep == 0 else 'time'],
                capture_output=True, text=True, cwd=ROOT)
            print(f'== {name} turn {rep} ({time.time() - t0:.1f} s, rc '
                  f'{out.returncode})', flush=True)
            print(out.stdout + out.stderr[-3000:], flush=True)
            ok &= out.returncode == 0
            rows += [json.loads(line) for line in out.stdout.splitlines()
                     if line.startswith('{')]
    print('mean of the two turns, bf16 (cuda_ms / device_ms / graph_ms '
          '/ host_us; bound_ms):')
    for name, _ in specs:
        kinds = sorted({r['kernel'] for r in rows if r['version'] == name
                        and 'cuda_ms' in r})
        for kind in kinds:
            total = [0.0] * 5
            for label, _ in levels() + FWD_CASES:
                rs = [r for r in rows if r['version'] == name
                      and r['kernel'] == kind and r['case'] == label]
                if not rs:
                    continue
                m = [sum(r[k] for r in rs) / len(rs)
                     for k in ('cuda_ms', 'device_ms', 'graph_ms',
                               'host_us')] + [rs[0]['bound_ms']]
                total = [t + v for t, v in zip(total, m)]
                print(f'  {name} {kind} {label}: {m[0]:.4f} / {m[1]:.4f} / '
                      f'{m[2]:.4f} / {m[3]:.1f}; {m[4]:.4f}')
            if kind.startswith('K1-bwd'):
                print(f'  {name} {kind}, 12 calls: {total[0]:.4f} / '
                      f'{total[1]:.4f} / {total[2]:.4f}; {total[4]:.4f}')
        swept = [r for r in rows if r['version'] == name
                 and r['kernel'].endswith('one_pass sweep')]
        if swept:
            print(f'  {name}, one-pass geometries by graph_ms (lanes x '
                  f'cluster: ms; * the planner\'s):')
        for kind, label in sorted({(r['kernel'], r['case'])
                                   for r in swept}):
            ms = sorted((r['graph_ms'], r['lanes'], r['cluster'],
                         r['planned']) for r in swept
                        if (r['kernel'], r['case']) == (kind, label)
                        and r['graph_ms'] is not None)
            print(f'    {kind[:-15]} {label}: ' + ', '.join(
                f'{ln}x{k}: {m:.4f}{"*" if p else ""}'
                for m, ln, k, p in ms))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
