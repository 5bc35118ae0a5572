#!/usr/bin/env python3
"""Build versions of the thin 3x3 conv kernels (K4, K4-wgrad) and time them
on one CUDA card, each in its own process, in turns.

    python3 tools/thin_conv_variants.py NAME=SOURCE.cu[:-DFLAG,...] ...
    python3 tools/thin_conv_variants.py --split OLD.cu

Each NAME=SOURCE builds ``SOURCE`` (a ``thin_conv.cu`` of any revision,
with its ``in_common.cuh`` from ``patchgan_tpu_torch/csrc``) with nvcc for
``sm_90a`` into ``tools/_build/NAME.so``, printing ptxas's registers,
shared memory and spills. Then, in one process per library (a library
carries its own CUDA runtime), in the order given and then reversed, it
checks K4 and K4-wgrad against F.conv2d / torch.nn.grad.conv2d_weight in
fp32 (TF32 off) at the s2d paths' shapes and four edge cases, in bf16 and
fp32 (libraries built with -D flags are timed only), and times both
kernels in bf16 with CUDA events (K4-wgrad also by a graph's replay) at
the s2d shapes: the 8-tile inference chunk (8, 12), the batch-16 step
(16, 12) and (16, 28), the merged validation batch (32, 12) and (32,
28), all 128 x 128 -> 64. It prints
each row as JSON, cuDNN's times at the same shapes, the card's name and
power limit, and the mean over the two turns of each library.

Each library also prints a digest of K4's outputs at every checked case
in both dtypes; the summary says whether they are bit-equal across the
versions.

``--split OLD.cu`` splits the time of the kernels of the
``thin_conv.cu`` before the persistent-grid redesign (``git show
1e710de:patchgan_tpu_torch/csrc/thin_conv.cu > OLD.cu``): it writes a
copy with compile-time switches (the MMA loop skipped, the staging done
for a block's first tile only, the forward's weight fill skipped, the
forward's epilogue skipped, the wgrad's reduce skipped) and runs the
variants of it. Its patches name that source's kernels and take no
later one.

``--split-wgmma NEW.cu`` splits the time of K4-wgrad's wgmma kernel
(``thin_wgrad_tma`` of a ``thin_conv.cu`` that has it): a copy with
compile-time switches (the wgmma and the shifted copies skipped: the TMA
ring alone; the copies skipped; the wgmma skipped; each block's tiles
loaded once into the ring and then only copied and multiplied; the
reduce skipped) and the variants of it, timed as above at the bf16 step
shapes.
"""
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, 'tools', '_build')
NVCC = ['/usr/local/cuda/bin/nvcc', '-gencode', 'arch=compute_90a,code=sm_90a',
        '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v',
        '-I', os.path.join(ROOT, 'patchgan_tpu_torch', 'csrc')]
# (label, N, Cin, H, W, Cout)
TIMED = [('infer (8,12)', 8, 12, 128, 128, 64),
         ('step (16,12)', 16, 12, 128, 128, 64),
         ('step (16,28)', 16, 28, 128, 128, 64),
         ('val (32,12)', 32, 12, 128, 128, 64),
         ('val (32,28)', 32, 28, 128, 128, 64)]
CHECK = TIMED + [('ragged', 3, 4, 40, 70, 28),
                 ('aligned partial', 2, 20, 24, 72, 40),
                 ('few tiles', 1, 12, 6, 8, 64),
                 ('max cin', 4, 32, 16, 64, 64),
                 ('cout 130', 2, 12, 10, 16, 130)]
# --split: (anchor in the 1e710de source, text put before it, text put
# after it); each anchor occurs once
SPLIT_EDITS = [
    ('  for (int i = tid; i < 9 * ks * ldw; i += blockDim.x)\n',
     '#ifndef SKIP_WFILL\n', ''),
    ('        ws[(r % 9 * ks + r / 9) * ldw + c] = v;\n      });\n',
     '', '#endif\n'),
    ('    stage_x(x, xs, p, cin, h, wd, cs);\n    __syncthreads();\n',
     '#ifdef STAGE_ONCE\n    if (t == blockIdx.x * per)\n#endif\n', ''),
    ('      for (int tap = 0; tap < 9; ++tap) {\n'
     '        const int r = tap / 3, s = tap - 3 * r;\n',
     '#ifndef SKIP_MMA\n', ''),
    ('      __syncthreads();  // every warp is done with xs, which cs reuses\n',
     '#endif\n', '#ifdef SKIP_EPI\n      if (cout < 0)\n#endif\n      {\n'),
    ('              from_f32<T>(cst[c * LDC + m]);\n      }\n', '', '      }\n'),
    ('    stage_x(x, xs, p, cin, h, wd, cs);\n    // dy of the tile',
     '#ifdef STAGE_ONCE\n    if (t == blockIdx.x * per) {\n#endif\n', ''),
    ('    __syncthreads();\n    if constexpr (kTensorCores) {\n'
     '      for (int m0 = 0; m0 < TM; m0 += 16) {',
     '#ifdef STAGE_ONCE\n    }\n#endif\n', ''),
    ('    if constexpr (kTensorCores) {\n      for (int m0 = 0; m0 < TM;',
     '#ifndef SKIP_MMA\n', ''),
    ('    __syncthreads();  // before the next tile restages dys and xs\n',
     '#endif\n', ''),
    ('  thin_wgrad_reduce<<<', '#ifndef SKIP_REDUCE\n', ''),
    ('      cin, cout, kstride<T>(cin));\n', '', '#endif\n'),
]
# appended to the split copy: blocks an SM holds of its bf16 kernels
SPLIT_OCCUPANCY = """
extern "C" int pgt_thin_occupancy(int cin, int wgrad) {
  using namespace pgt::thin;
  using T = __nv_bfloat16;
  int nb = 0;
  if (wgrad) {
    cudaFuncSetAttribute(thin_wgrad<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)wgrad_smem<T>(cin));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, thin_wgrad<T>,
                                                  WG_THREADS, wgrad_smem<T>(cin));
  } else {
    cudaFuncSetAttribute(thin_fwd<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)fwd_smem<T>(cin));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, thin_fwd<T>,
                                                  FWD_THREADS, fwd_smem<T>(cin));
  }
  return nb;
}
"""
SPLIT_VARIANTS = [('base', ''), ('mma', '-DSKIP_MMA'),
                  ('once', '-DSTAGE_ONCE'), ('wfill', '-DSKIP_WFILL'),
                  ('epi', '-DSKIP_EPI'), ('red', '-DSKIP_REDUCE'),
                  ('oncemma', '-DSTAGE_ONCE,-DSKIP_MMA')]
# --split-wgmma: (anchor in thin_wgrad_tma's source, its replacement)
WGMMA_SWITCHES = """
#ifdef SKIP_MMA
constexpr bool kSplitMma = false;
#else
constexpr bool kSplitMma = true;
#endif
#ifdef SKIP_SHIFT
constexpr bool kSplitShift = false;
#else
constexpr bool kSplitShift = true;
#endif
#ifdef LOAD_ONCE
constexpr bool kSplitReload = false;
#else
constexpr bool kSplitReload = true;
#endif
"""
WGMMA_EDITS = [
    ('#include "wgmma.cuh"\n', '#include "wgmma.cuh"\n' + WGMMA_SWITCHES),
    # once each stage's first load has landed, parity 0 never waits
    ('    wg::mbar_wait(wg::smem_u32(full + s), parity);\n',
     '    wg::mbar_wait(wg::smem_u32(full + s), kSplitReload ? parity : 0u);\n'),
    ('        wg::Wgmma<N>::mma(acc, da + 2 * kk, db + 2 * kk);\n',
     '        if (kSplitMma) wg::Wgmma<N>::mma(acc, da + 2 * kk, '
     'db + 2 * kk);\n'),
    ('    shift_copies<CP>(', '    if (kSplitShift) shift_copies<CP>('),
    ('    if (tid == 0 && t + S * gridDim.x < tiles) issue(',
     '    if (kSplitReload && tid == 0 && t + S * gridDim.x < tiles) issue('),
    ('  thin_wgrad_reduce<<<(outs + 31) / 32, dim3(32, RED_ROWS), 0, st>>>(\n'
     '      static_cast<const float*>(part), static_cast<float*>(dw), grid.x,\n'
     '      grid.y, cin, cout, CP);\n',
     '#ifndef SKIP_REDUCE\n'
     '  thin_wgrad_reduce<<<(outs + 31) / 32, dim3(32, RED_ROWS), 0, st>>>(\n'
     '      static_cast<const float*>(part), static_cast<float*>(dw), grid.x,\n'
     '      grid.y, cin, cout, CP);\n#endif\n'),
]
WGMMA_VARIANTS = [('base', ''), ('tma', '-DSKIP_MMA,-DSKIP_SHIFT'),
                  ('noshift', '-DSKIP_SHIFT'), ('nomma', '-DSKIP_MMA'),
                  ('once', '-DLOAD_ONCE'), ('red', '-DSKIP_REDUCE')]


def split_source(src, dst):
    s = open(src).read()
    for anchor, before, after in SPLIT_EDITS:
        i = s.find(anchor)
        if i < 0 or s.find(anchor, i + 1) >= 0:
            raise SystemExit(f'--split: anchor not found once: {anchor!r}')
        s = s[:i] + before + anchor + after + s[i + len(anchor):]
    with open(dst, 'w') as f:
        f.write(s + SPLIT_OCCUPANCY)


def split_wgmma_source(src, dst):
    """A copy of ``src`` with WGMMA_EDITS' switches (its headers come from
    the build's -I)."""
    s = open(src).read()
    for anchor, new in WGMMA_EDITS:
        if s.count(anchor) != 1:
            raise SystemExit(f'--split-wgmma: anchor not found once: '
                             f'{anchor!r}')
        s = s.replace(anchor, new)
    with open(dst, 'w') as f:
        f.write(s)


def build(specs):
    os.makedirs(BUILD, exist_ok=True)
    procs = []
    for spec in specs:
        name, rest = spec.split('=', 1)
        path, _, defs = rest.partition(':')
        procs.append((name, subprocess.Popen(
            NVCC + [d for d in defs.split(',') if d]
            + ['-o', os.path.join(BUILD, f'{name}.so'), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, p in procs:
        log, _ = p.communicate()
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line or 'error' in line \
                    or 'Compiling entry' in line:
                print(f'  ptxas {name}: {line.strip()}')
        if p.returncode:
            raise SystemExit(f'{name}: nvcc failed\n{log}')


def load(name):
    lib = ctypes.CDLL(os.path.join(BUILD, f'{name}.so'))
    p, i = ctypes.c_void_p, ctypes.c_int
    # the packed-weight forward takes a scratch wp after w
    lib.packed = hasattr(lib, 'pgt_thin_conv_pack')
    lib.pgt_thin_conv_fwd.argtypes = [p] * (4 if lib.packed else 3) + \
        [i] * 6 + [p]
    if lib.packed:
        lib.pgt_thin_conv_pack.argtypes = [p, p, i, i, i, p]
        lib.pgt_thin_conv_packed_size.argtypes = [i, i, i]
    if hasattr(lib, 'pgt_thin_conv_grid'):
        lib.pgt_thin_conv_grid.argtypes = [i] * 7 + [ctypes.POINTER(i)]
    lib.pgt_thin_conv_wgrad_scratch.argtypes = [i] * 6
    lib.pgt_thin_conv_wgrad_scratch.restype = ctypes.c_long
    lib.pgt_thin_conv_wgrad.argtypes = [p] * 4 + [i] * 6 + [p]
    return lib


def ms(fn, iters=50, warmup=5):
    """Mean ms of fn on the card over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def replay_ms(fn, iters=20):
    """Mean ms of fn on the card alone: CUDA events around the replays of
    a CUDA graph of ``iters`` calls (captured after a warm-up on a side
    stream)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (5 * iters)


def run_one(spec, rep, check):
    """One library in this process: check (if asked) and time it."""
    import torch
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    name = spec.split('=', 1)[0]
    lib = load(name)

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def fwd(x, w):
        n, cin, h, wd = x.shape
        bf = int(x.dtype == torch.bfloat16)
        y = torch.empty(n, w.shape[0], h, wd, dtype=x.dtype, device='cuda')
        ptrs = [x.data_ptr(), w.data_ptr()]
        if lib.packed:
            wp = torch.empty(lib.pgt_thin_conv_packed_size(cin, w.shape[0],
                                                           bf),
                             dtype=x.dtype, device='cuda')
            ptrs.append(wp.data_ptr())
        rc = lib.pgt_thin_conv_fwd(*ptrs, y.data_ptr(), n, cin, h, wd,
                                   w.shape[0], bf, stream())
        assert rc == 0, rc
        return y

    def wgrad(x, dy):
        n, cin, h, wd = x.shape
        cout = dy.shape[1]
        bf = int(x.dtype == torch.bfloat16)
        part = torch.empty(lib.pgt_thin_conv_wgrad_scratch(n, cin, h, wd,
                                                           cout, bf),
                           device='cuda')
        dw = torch.empty(cout, cin, 3, 3, device='cuda')
        rc = lib.pgt_thin_conv_wgrad(x.data_ptr(), dy.data_ptr(),
                                     part.data_ptr(), dw.data_ptr(), n, cin,
                                     h, wd, cout, bf, stream())
        assert rc == 0, rc
        return dw

    gen = torch.Generator(device='cuda').manual_seed(9)
    data = {}
    for label, n, cin, h, wd, cout in CHECK:
        x = torch.randn(n, cin, h, wd, generator=gen, device='cuda')
        w = torch.randn(cout, cin, 3, 3, generator=gen, device='cuda') * \
            0.5 / (9 * cin) ** 0.5
        dy = torch.randn(n, cout, h, wd, generator=gen, device='cuda')
        data[label] = (x, w, dy)
    ok = True
    for label, (x, w, dy) in data.items():
        for dt in (torch.bfloat16, torch.float32):
            y = fwd(x.to(dt), w.to(dt))
            print(json.dumps({'lib': name, 'case': label, 'dtype': str(dt),
                              'k4_digest': hashlib.sha256(
                                  y.view(torch.uint8).cpu().numpy()
                                  .tobytes()).hexdigest()[:16]}),
                  flush=True)
    for label, (x, w, dy) in data.items() if check else ():
        for dt in (torch.bfloat16, torch.float32):
            xd, wdd, dyd = x.to(dt), w.to(dt), dy.to(dt)
            want = F.conv2d(xd.float(), wdd.float(), padding=1)
            want_w = torch.nn.grad.conv2d_weight(xd.float(), wdd.shape,
                                                 dyd.float(), padding=1)
            e = (fwd(xd, wdd).float() - want).abs().max().item()
            ew = (wgrad(xd, dyd) - want_w).abs().max().item() / max(
                1.0, want_w.abs().max().item())
            good = e <= (3e-2 if dt == torch.bfloat16 else 1e-3) and \
                ew <= 1e-3
            ok &= good
            print(f'  {name} {label} {str(dt)[6:]}: K4 max_abs_err {e:.3e}, '
                  f'K4-wgrad max_abs_err / max(1, max |dw|) {ew:.3e}'
                  f'{"" if good else "  FAIL"}', flush=True)
    for label, n, cin, h, wd, cout in TIMED:
        x, w, dy = (t.bfloat16() for t in data[label])
        r = {'lib': name, 'case': label, 'rep': rep,
             'fwd_ms': ms(lambda: fwd(x, w)),
             'wgrad_ms': ms(lambda: wgrad(x, dy)),
             'wgrad_replay_ms': replay_ms(lambda: wgrad(x, dy))}
        if hasattr(lib, 'pgt_thin_occupancy'):
            lib.pgt_thin_occupancy.argtypes = [ctypes.c_int] * 2
            r['fwd_blocks_per_sm'] = lib.pgt_thin_occupancy(cin, 0)
            r['wgrad_blocks_per_sm'] = lib.pgt_thin_occupancy(cin, 1)
        if hasattr(lib, 'pgt_thin_conv_grid'):
            per_sm = ctypes.c_int(0)
            for key, wg in (('fwd', 0), ('wgrad', 1)):
                r[f'{key}_grid'] = lib.pgt_thin_conv_grid(
                    n, cin, h, wd, cout, 1, wg, ctypes.byref(per_sm))
                r[f'{key}_blocks_per_sm'] = per_sm.value
        print(json.dumps(r), flush=True)
    return ok


def cudnn_rows():
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device='cuda').manual_seed(9)
    for label, n, cin, h, wd, cout in TIMED:
        x = torch.randn(n, cin, h, wd, generator=gen, device='cuda').bfloat16()
        w = torch.randn(cout, cin, 3, 3, generator=gen, device='cuda') \
            .bfloat16()
        dy = torch.randn(n, cout, h, wd, generator=gen, device='cuda') \
            .bfloat16()

        def lib():
            return torch.nn.grad.conv2d_weight(x, w.shape, dy, padding=1)
        print(json.dumps({'lib': 'cudnn', 'case': label,
                          'fwd_ms': ms(lambda: F.conv2d(x, w, padding=1)),
                          'wgrad_ms': ms(lib),
                          'wgrad_replay_ms': replay_ms(lib)}), flush=True)


def main():
    args = sys.argv[1:]
    if args and args[0] == '--run':      # child: one library
        ok = run_one(args[3], int(args[1]), args[2] == 'check')
        return 0 if ok else 1
    if args and args[0] == '--cudnn':
        cudnn_rows()
        return 0
    specs = [a for a in args if '=' in a and not a.startswith('--')]
    if '--split-wgmma' in args:
        src = os.path.abspath(args[args.index('--split-wgmma') + 1])
        os.makedirs(BUILD, exist_ok=True)
        dst = os.path.join(BUILD, 'split_wgmma.cu')
        split_wgmma_source(src, dst)
        specs += [f'{n}={dst}:{d}' if d else f'{n}={dst}'
                  for n, d in WGMMA_VARIANTS]
    if '--split' in args:
        src = args[args.index('--split') + 1]
        os.makedirs(BUILD, exist_ok=True)
        dst = os.path.join(BUILD, 'split.cu')
        split_source(src, dst)
        specs += [f'{n}={dst}:{d}' if d else f'{n}={dst}'
                  for n, d in SPLIT_VARIANTS]
    t0 = time.time()
    build(specs)
    print(f'build {time.time() - t0:.1f} s', flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    rows, ok = [], True
    for rep in range(2):
        for spec in (specs if rep == 0 else specs[::-1]):
            check = rep == 0 and ':' not in spec.split('=', 1)[1]
            out = subprocess.run(
                [sys.executable, __file__, '--run', str(rep),
                 'check' if check else 'time', spec],
                capture_output=True, text=True)
            print(out.stdout + out.stderr[-3000:], flush=True)
            ok &= out.returncode == 0
            rows += [json.loads(line) for line in out.stdout.splitlines()
                     if line.startswith('{')]
    out = subprocess.run([sys.executable, __file__, '--cudnn'],
                         capture_output=True, text=True)
    print(out.stdout + out.stderr[-3000:], flush=True)
    digests = {}
    for r in rows:
        if 'k4_digest' in r:
            digests.setdefault((r['case'], r['dtype']), set()).add(
                r['k4_digest'])
    print(f'K4 outputs bit-equal across the versions at every case in both '
          f'dtypes: {all(len(v) == 1 for v in digests.values())}')
    print('mean of the two turns, bf16, ms (K4 / K4-wgrad / K4-wgrad by '
          'a graph\'s replay):')
    for spec in specs:
        name = spec.split('=')[0]
        line = [name]
        for label, *_ in TIMED:
            rs = [r for r in rows if r['lib'] == name and r['case'] == label
                  and 'fwd_ms' in r]
            f = sum(r['fwd_ms'] for r in rs) / len(rs)
            g = sum(r['wgrad_ms'] for r in rs) / len(rs)
            gr = sum(r['wgrad_replay_ms'] for r in rs) / len(rs)
            line.append(f'{label} {f:.4f} / {g:.4f} / {gr:.4f}')
        print('  ' + ' | '.join(line))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
