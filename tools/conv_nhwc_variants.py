#!/usr/bin/env python3
"""Time versions of the NHWC (channels_last) forms of K2 and K3 on one
CUDA card, each version in its own process, in turns; with ``--nchw``
their NCHW forms instead.

    python3 tools/conv_nhwc_variants.py NAME=CHECKOUT ... [--nchw]
        [--sweep] [--check]

Each NAME=CHECKOUT is a checkout of this repository (``.`` for the
working tree; another revision unpacked with ``git archive`` into an
ignored directory such as ``chip_scratch/``). Its own
``patchgan_tpu_torch`` is imported in a child process, which builds K2's
and K3's kernels from that checkout's sources (printing ptxas's
registers, shared memory and spills) and, in the order given and then
reversed:

- holds K2's NHWC form at enc1-enc6 and K3's at dec1-dec5 of config 2's
  step (batch 16, 256 px, nf=64, relu) against their plain versions in
  bf16 (tolerance 3e-2), in each GEMM core the version can be made to
  launch (the wrappers' private ``_nhwc_core``: ``wgmma`` and ``wmma``;
  ``nhwc`` where it has no such argument), the launch counted on the
  core asked for, and two launches compared bit for bit;
- times each core at each level in bf16 three ways: ``cuda_ms``, CUDA
  events around 20 back-to-back wrapper calls (as ``chip_smoke.py``
  does), ``graph_ms``, CUDA events around the replay of a CUDA graph
  of 20 calls (no host work), and ``host_ms``, the host's wall to issue
  a call; beside them the library call (cuDNN's
  channels_last convolution, instance norm and relu) and the bound (the
  larger of the operations at the bf16 peak and the bytes at the memory
  rate).

``--nchw`` does the same for the NCHW forms, with NCHW-contiguous
inputs, at the shapes of an 8-tile bucket of the inference engine (batch
8, 256 px) and of one whole 1280x960 image in spatial mode (batch 1,
padded to 1024x1280): the cores as the wrappers' private ``_core`` names
them (``nchw`` where a version has no such argument), the library call
cuDNN's NCHW convolution, and beside them ``layout``, the layout passes
the wgmma core's C call makes (``nchw_to_nhwc`` on x and the weight for
K2, on x and skip for K3), alone.

``--sweep`` also times the wgmma core at every (BN, stages) its C entry
points take (``_nhwc_core`` or ``_core`` = ``('wgmma', BN, stages)``, by
a graph's replay, the planner's choice marked), so that the planner's
choices can be set from one call. ``--check`` runs the checks alone. It
prints the card's name and power limit, and per version and core the
mean of its two turns at each level and the sums over K2's six and K3's
five calls of each shape set.
"""
import importlib
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES = 3.35e12
PEAK_BF16 = 989e12
ITERS = 20
TOL = 3e-2
BATCH, SIZE, NF = 16, 256, 64
# the shape sets: (name, batch, image rows, image columns); the NHWC
# forms' is config 2's step, the NCHW forms' the engine's 8-tile bucket
# and one whole 1280x960 image in spatial mode (chip_smoke.py's B, SIZE
# and SPATIAL_PAD)
NHWC_SETS = (('step', BATCH, SIZE, SIZE),)
NCHW_SETS = (('8 tiles', 8, SIZE, SIZE), ('image', 1, 1024, 1280))


def levels(n, h, w):
    """(kernel, label, x shape, skip channels, Cout) of the nf=64
    generator on n images of h x w: K2 enc1-enc6, K3 dec1-dec5
    (``chip_smoke.make_cases``)."""
    f = [NF, 2 * NF, 4 * NF, 8 * NF, 8 * NF, 8 * NF, 8 * NF]
    out, hh, ww = [], h // 2, w // 2
    for lvl in range(1, 7):
        out.append(('K2', f'enc{lvl}', (n, f[lvl - 1], hh, ww), 0, f[lvl]))
        hh, ww = hh // 2, ww // 2
    for lvl, cx, cs, cout in [(1, 8 * NF, 8 * NF, 8 * NF),
                              (2, 8 * NF, 8 * NF, 8 * NF),
                              (3, 8 * NF, 8 * NF, 4 * NF),
                              (4, 4 * NF, 4 * NF, 2 * NF),
                              (5, 2 * NF, 2 * NF, NF)]:
        out.append(('K3', f'dec{lvl}', (n, cx, h >> (7 - lvl),
                                        w >> (7 - lvl)), cs, cout))
    return out


def bound_ms(flops, nbytes):
    return max(flops / PEAK_BF16, nbytes / HBM_BYTES) * 1e3


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


def host_ms(torch, fn):
    """The host's ms to issue one call: the wall of ITERS back-to-back
    calls after a synchronisation, the card left to catch up after."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / ITERS
    torch.cuda.synchronize()
    return ms


def graph_ms(torch, fn):
    """CUDA events around the replay of a graph of ITERS calls."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
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


def cores(wrapper, form):
    """The cores of ``form`` ('nhwc' or 'nchw') a version's wrapper can be
    told to launch: (kind, keyword arguments, the wgmma core's launches a
    call adds, None where the version has no such count)."""
    key = '_nhwc_core' if form == 'nhwc' else '_core'
    if key in inspect.signature(wrapper).parameters:
        return [('wgmma', {key: 'wgmma'}, 1), ('wmma', {key: 'wmma'}, 0)]
    return [(form, {}, None)]


def run_child(checkout, name, rep, mode, form):
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    import torch.nn.functional as F
    from patchgan_tpu_torch.ops.kernels import _build
    # the modules (the package's names of the same spelling are the
    # wrappers)
    k2m = importlib.import_module('patchgan_tpu_torch.ops.kernels.'
                                  'conv_norm_act')
    k3m = importlib.import_module('patchgan_tpu_torch.ops.kernels.'
                                  'convt_norm_act')
    _build.build(('conv_norm_act', 'convt_norm_act'))
    for lib, log in _build.build_log.items():
        for line in log.splitlines():
            if any(k in line for k in ('registers', 'spill', 'Compiling')):
                print(f'  ptxas {lib}: {line.strip()}', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(22)
    ok = True

    def emit(row):
        row.update(version=name, rep=rep)
        print(json.dumps(row), flush=True)

    def cl(t):
        if form == 'nchw':
            return t.contiguous()
        return torch.empty_like(t, memory_format=torch.channels_last) \
            .copy_(t)

    # the NCHW form's layout passes alone, where the version has them
    to_nhwc = getattr(k2m, 'nchw_to_nhwc', None) if form == 'nchw' \
        else None

    def make(kernel, shape, cs, cout):
        n, cin, h, w = shape
        x = torch.randn(*shape, generator=gen, device='cuda')
        if kernel == 'K2':
            wt = torch.randn(cout, cin, 4, 4, generator=gen, device='cuda') \
                * (2.0 / (32 * (cin + cout))) ** 0.5
            args = (cl(x.bfloat16()), cl(wt.bfloat16()), 1e-5, 'relu')
            macs = n * (h // 2) * (w // 2) * cout * 16 * cin
            elems = x.numel() + wt.numel() + n * cout * h * w // 4
            return (k2m.conv_norm_act, k2m.conv_norm_act_plain, args,
                    lambda x, w, eps, a: F.relu(F.instance_norm(
                        F.conv2d(x, w, stride=2, padding=1), eps=eps)),
                    2 * macs, 2 * elems, args[:2])
        s = torch.randn(n, cs, h, w, generator=gen, device='cuda')
        wt = torch.randn(cin + cs, cout, 4, 4, generator=gen, device='cuda') \
            * (2.0 / (16 * (cin + cs + cout))) ** 0.5
        args = (cl(x.bfloat16()), cl(wt.bfloat16()), 1e-5, 'relu',
                cl(s.bfloat16()))
        macs = n * 4 * h * w * cout * 4 * (cin + cs)
        elems = x.numel() + s.numel() + wt.numel() + n * cout * 4 * h * w
        return (k3m.convt_norm_act, k3m.convt_norm_act_plain, args,
                lambda x, w, eps, a, s: F.relu(F.instance_norm(
                    F.conv_transpose2d(torch.cat([x, s], 1), w, stride=2,
                                       padding=1), eps=eps)),
                2 * macs, 2 * elems, (args[0], args[4]))

    def check(kernel, label, wrapper, plain, args, kind, kw, adds):
        nonlocal ok
        before = getattr(wrapper, 'launches_wgmma', 0)
        got = wrapper(*args, **kw)
        again = wrapper(*args, **kw)
        want = plain(*(a.float() if torch.is_tensor(a) else a
                       for a in args)).float()
        torch.cuda.synchronize()
        e = (got.float() - want).abs().max().item()
        counted = adds is None or \
            wrapper.launches_wgmma == before + 2 * adds
        same = torch.equal(got, again)
        good = e <= TOL and counted and same
        ok &= good
        print(f'  {name} {kernel} {label} {kind}: max_abs_err {e:.3e} (tol '
              f'{TOL:.0e}), launched on it {counted}, two launches equal '
              f'{same}{"" if good else "  FAIL"}', flush=True)
        return e

    sets = NCHW_SETS if form == 'nchw' else NHWC_SETS
    with torch.inference_mode():
        for set_name, n, h, w in sets:
            for kernel, label, shape, cs, cout in levels(n, h, w):
                label = f'{set_name} {label}'
                wrapper, plain, args, library, flops, nbytes, moved = make(
                    kernel, shape, cs, cout)
                kinds = cores(wrapper, form)
                errs = {kind: check(kernel, label, wrapper, plain, args,
                                    kind, kw, adds) if rep == 0 else None
                        for kind, kw, adds in kinds}
                if mode == 'check':
                    continue
                row = {'kernel': kernel, 'set': set_name, 'case': label,
                       'shape': shape, 'cs': cs, 'cout': cout,
                       'library_cuda_ms': cuda_ms(
                           torch, lambda: library(*args)),
                       'library_graph_ms': graph_ms(
                           torch, lambda: library(*args)),
                       'bound_ms': bound_ms(flops, nbytes)}
                for kind, kw, _ in kinds:
                    row[f'{kind}_cuda_ms'] = cuda_ms(
                        torch, lambda: wrapper(*args, **kw))
                    row[f'{kind}_graph_ms'] = graph_ms(
                        torch, lambda: wrapper(*args, **kw))
                    row[f'{kind}_host_ms'] = host_ms(
                        torch, lambda: wrapper(*args, **kw))
                    row[f'{kind}_max_abs_err'] = errs[kind]
                if to_nhwc is not None:
                    def layout():
                        return [to_nhwc(t) for t in moved]
                    row['layout_cuda_ms'] = cuda_ms(torch, layout)
                    row['layout_graph_ms'] = graph_ms(torch, layout)
                emit(row)
                if mode != 'sweep' or kinds[0][0] != 'wgmma':
                    continue
                plan = (k2m.conv_nhwc_plan(*shape, cout, torch.bfloat16)
                        if kernel == 'K2' else
                        k3m.convt_nhwc_plan(shape[0], shape[1], cs,
                                            *shape[2:], cout,
                                            torch.bfloat16))
                key = next(iter(kinds[0][1]))
                for bn in k2m.WGMMA_BNS:
                    for stages in k2m.WGMMA_STAGES:
                        if cout % bn:
                            continue
                        kw = {key: ('wgmma', bn, stages)}
                        emit({'kernel': kernel, 'case': label,
                              'sweep': True, 'bn': bn, 'stages': stages,
                              'graph_ms': graph_ms(
                                  torch, lambda: wrapper(*args, **kw)),
                              'planned': (plan.bn, plan.stages) ==
                              (bn, stages)})
    return ok


def main():
    args = sys.argv[1:]
    if args and args[0] == '--child':
        ok = run_child(args[1], args[2], int(args[3]), args[4], args[5])
        return 0 if ok else 1
    mode = 'check' if '--check' in args else \
        'sweep' if '--sweep' in args else 'time'
    form = 'nchw' if '--nchw' in args else 'nhwc'
    sets = [s[0] for s in (NCHW_SETS if form == 'nchw' else NHWC_SETS)]
    specs = [a.split('=', 1) for a in args if '=' in a]
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    rows, ok = [], True
    for rep in range(1 if mode == 'check' else 2):
        for name, checkout in (specs if rep == 0 else specs[::-1]):
            t0 = time.time()
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--child',
                 checkout, name, str(rep),
                 mode if rep == 0 else 'time', form],
                capture_output=True, text=True, cwd=ROOT)
            print(f'== {name} turn {rep} ({time.time() - t0:.1f} s, rc '
                  f'{out.returncode})', flush=True)
            print(out.stdout + out.stderr[-3000:], flush=True)
            ok &= out.returncode == 0
            rows += [json.loads(line) for line in out.stdout.splitlines()
                     if line.startswith('{')]
    if mode == 'check':
        return 0 if ok else 1
    print('mean of the two turns, bf16, ms (cuda_ms / graph_ms / host; '
          'library cuda_ms / graph_ms; bound):')
    for name, _ in specs:
        mine = [r for r in rows if r['version'] == name and 'sweep' not in r]
        kinds = sorted({k[:-len('_cuda_ms')] for r in mine for k in r
                        if k.endswith('_cuda_ms')})
        for set_name, kernel in [(s, k) for s in sets
                                 for k in ('K2', 'K3')]:
            total = {}
            for label in sorted({r['case'] for r in mine
                                 if r['kernel'] == kernel
                                 and r.get('set', 'step') == set_name}):
                rs = [r for r in mine if r['case'] == label]
                mean = {f'{k}_{t}': sum(r[f'{k}_{t}'] for r in rs) / len(rs)
                        for k in kinds for t in ('cuda_ms', 'graph_ms',
                                                 'host_ms')
                        if f'{k}_{t}' in rs[0]}
                mean['bound_ms'] = rs[0]['bound_ms']
                for k, v in mean.items():
                    total[k] = total.get(k, 0.0) + v
                print(f'  {name} {kernel} {label}: ' + '; '.join(
                    f'{k} {mean[k + "_cuda_ms"]:.4f} / '
                    f'{mean[k + "_graph_ms"]:.4f}' + (
                        f' / host {mean[k + "_host_ms"]:.4f}'
                        if k + '_host_ms' in mean else '') for k in kinds)
                    + f'; bound {mean["bound_ms"]:.4f}', flush=True)
            if total:
                print(f'  {name} {kernel}, the {set_name} calls: '
                      + '; '.join(f'{k} {total[k + "_cuda_ms"]:.4f} / '
                                  f'{total[k + "_graph_ms"]:.4f}' + (
                                      f' / host {total[k + "_host_ms"]:.4f}'
                                      if k + '_host_ms' in total else '')
                                  for k in kinds)
                      + f'; bound {total["bound_ms"]:.4f}', flush=True)
        swept = [r for r in rows if r['version'] == name and 'sweep' in r]
        if swept:
            print(f'  {name}, the wgmma core by graph_ms (BN x stages: ms; '
                  f'* the planner\'s):')
        for kernel, label in sorted({(r['kernel'], r['case'])
                                     for r in swept}):
            ms = sorted((r['graph_ms'], r['bn'], r['stages'], r['planned'])
                        for r in swept
                        if (r['kernel'], r['case']) == (kernel, label))
            print(f'    {kernel} {label}: ' + ', '.join(
                f'{bn}x{st}: {m:.4f}{"*" if p else ""}'
                for m, bn, st, p in ms))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
