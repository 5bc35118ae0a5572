#!/usr/bin/env python3
"""Drive the PyTorch port (``patchgan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository. In order:

1. prints the card's name and power limit, the torch / CUDA versions, and
   builds every kernel from ``patchgan_tpu_torch/csrc`` (one nvcc per
   source, all at once), with the build time;
2. kernel phase: each kernel (K1 instance norm + act, K2 conv + IN + act,
   K3 convT + IN + act) at every shape the nf=64 generator gives it for
   8 tiles of 256 px, in bf16 and fp32, against its plain PyTorch version
   on the same inputs with TF32 off. Tolerances: fp32 inputs, atol 1e-3
   (another summation order); bf16 inputs against the plain version in
   fp32 on the same bf16-rounded inputs, atol 3e-2 (one bf16 rounding of
   outputs of magnitude up to ~5). K3 also runs a case with H != W, and
   every kernel all four activations at one shape. Times (CUDA events):
   the kernel, its plain version, and a library yardstick (cuDNN conv +
   F.instance_norm + activation, which the port never calls), beside the
   bound max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s);
3. the main path: ``patchgan_infer -d cuda`` (bf16) with a random nf=64
   3 -> 7-class generator on four images (1280x960, 640x480, 256x256,
   200x150), checking each mask's shape and labels, and that K1, K2 and
   K3 ran 1, 6 and 5 times per forward chunk;
4. the full nf=64 forward on one bucket of 8 tiles: the kernel path in
   fp32 against the plain path (the same model on the CPU), max |dprob|
   <= 1e-3; the bf16 kernel path against it, reported;
5. masks/s for the 1280x960 image, one image at a time, in five windows
   of at least 2 s each (every reading and their median), and tiles/s
   for the bare forward at buckets 8 and 32.

It prints a JSON summary of the kernels, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Any failure
exits non-zero before that line; without a CUDA device it exits 2.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12     # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_FP32 = 67e12      # fp32 FLOP/s outside the tensor cores
HBM_BYTES = 3.35e12    # device memory bytes/s
B = 8                  # tiles per bucket in the kernel phase
NF, SIZE, IN_C, OUT_C = 64, 256, 3, 7
ACTS = (None, 'tanh', 'relu', 'leakyrelu')
TOL = {'float32': 1e-3, 'bfloat16': 3e-2}
WINDOWS, WINDOW_S = 5, 2.0   # masks/s: timing windows, seconds each


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops > t_bytes
                                       else 'bytes')


class Kernel:
    """One kernel: where it lives, what it replaces, its wrapper and
    plain version, and its timing rows from the kernel phase."""

    def __init__(self, name, source, replaces, wrapper, plain):
        self.name, self.source, self.replaces = name, source, replaces
        self.wrapper, self.plain = wrapper, plain
        self.rows = []


def make_cases(torch, F, kernels):
    """The kernel phase's cases at the nf=64 main-path shapes, 8 tiles:
    (kernel, label, make(dtype, act) -> wrapper args, library(*args),
    FLOPs, elements read + written, whether to try every activation)."""
    k1, k2, k3 = kernels
    gen = torch.Generator(device='cuda').manual_seed(0)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device='cuda') * scale

    cases = []
    # K1: enc0's epilogue, after the 3 -> 64 conv at 128 x 128
    shape = (B, NF, SIZE // 2, SIZE // 2)
    x = rand(*shape)
    numel = x.numel()
    cases.append((k1, f'enc0 {shape}', lambda dt, a=None, x=x: (
        x.to(dt), 1e-5, a or 'relu'),
        lambda x, eps, a: F.relu(F.instance_norm(x, eps=eps)),
        6 * numel, 2 * numel, True))
    # K2: enc1-enc6
    filts = [NF, 2 * NF, 4 * NF, 8 * NF, 8 * NF, 8 * NF, 8 * NF]
    hw = SIZE // 2
    for lvl in range(1, 7):
        cin, cout = filts[lvl - 1], filts[lvl]
        x = rand(B, cin, hw, hw)
        w = rand(cout, cin, 4, 4, scale=(2.0 / (32 * (cin + cout))) ** 0.5)
        ho = hw // 2
        macs = B * ho * ho * cout * 16 * cin
        elems = x.numel() + w.numel() + B * cout * ho * ho
        cases.append((k2, f'enc{lvl} {cin}x{hw}^2->{cout}x{ho}^2',
                      lambda dt, a=None, x=x, w=w: (
                          x.to(dt), w.to(dt), 1e-5, a or 'relu'),
                      lambda x, w, eps, a: F.relu(F.instance_norm(
                          F.conv2d(x, w, stride=2, padding=1), eps=eps)),
                      2 * macs, elems, lvl == 3))
        hw = ho
    # K3: dec1-dec5, (level, H, W, x channels, skip channels, Cout): dec1
    # reads dec0's 4x4 output and the 4x4 enc5 skip, dec5 reads 64x64
    shapes = [(1, 4, 4, 8 * NF, 8 * NF, 8 * NF),
              (2, 8, 8, 8 * NF, 8 * NF, 8 * NF),
              (3, 16, 16, 8 * NF, 8 * NF, 4 * NF),
              (4, 32, 32, 4 * NF, 4 * NF, 2 * NF),
              (5, 64, 64, 2 * NF, 2 * NF, NF),
              ('H!=W', 24, 40, 2 * NF, 2 * NF, NF)]
    for lvl, h, wd, cx, cs, cout in shapes:
        x = rand(B, cx, h, wd)
        s = rand(B, cs, h, wd)
        w = rand(cx + cs, cout, 4, 4,
                 scale=(2.0 / (16 * (cx + cs + cout))) ** 0.5)
        macs = B * 4 * h * wd * cout * 4 * (cx + cs)
        elems = x.numel() + s.numel() + w.numel() + B * cout * 4 * h * wd
        label = (f'dec{lvl} ' if isinstance(lvl, int) else f'{lvl} ') + \
            f'({cx}+{cs})x{h}x{wd}->{cout}x{2 * h}x{2 * wd}'
        cases.append((k3, label,
                      lambda dt, a=None, x=x, s=s, w=w: (
                          x.to(dt), w.to(dt), 1e-5, a or 'relu', s.to(dt)),
                      lambda x, w, eps, a, s: F.relu(F.instance_norm(
                          F.conv_transpose2d(torch.cat([x, s], 1), w,
                                             stride=2, padding=1),
                          eps=eps)),
                      2 * macs, elems, lvl == 3))
    return cases


def kernel_phase(torch, F, kernels):
    def err(kernel, args32, args):
        got = kernel.wrapper(*args).float()
        want = kernel.plain(*args32).float()
        torch.cuda.synchronize()
        return (got - want).abs().max().item()

    def as_fp32(args):
        return tuple(a.float() if torch.is_tensor(a) else a for a in args)

    for kernel, label, make, library, flops, elems, all_acts in \
            make_cases(torch, F, kernels):
        errs = {}
        for dname, dt in (('bfloat16', torch.bfloat16),
                          ('float32', torch.float32)):
            for act in (ACTS if all_acts else ('relu',)):
                args = make(dt, act)
                e = err(kernel, as_fp32(args), args)
                ok = e <= TOL[dname]
                print(f'  {kernel.name} {label} {dname} act={act}: '
                      f'max_abs_err {e:.3e} (tol {TOL[dname]:.0e})'
                      f'{"" if ok else "  FAIL"}', flush=True)
                if not ok:
                    raise AssertionError(f'{kernel.name} {label} {dname} '
                                         f'act={act}: {e} > {TOL[dname]}')
                errs.setdefault(dname, 0.0)
                errs[dname] = max(errs[dname], e)
        if label.startswith('H!=W'):
            continue
        args = make(torch.bfloat16)
        k_ms = cuda_ms(lambda: kernel.wrapper(*args))
        p_ms = cuda_ms(lambda: kernel.plain(*args))
        lib_ms = cuda_ms(lambda: library(*args))
        peak = PEAK_FP32 if kernel.name == 'instance_norm_act' else PEAK_BF16
        b_ms, b_by = bound(flops, 2 * elems, peak)
        row = {'kernel': kernel.name, 'case': label, 'dtype': 'bfloat16',
               'kernel_ms': k_ms, 'plain_ms': p_ms, 'library_ms': lib_ms,
               'bound_ms': b_ms, 'bound_by': b_by,
               'max_abs_err_bf16': errs['bfloat16'],
               'max_abs_err_fp32': errs['float32']}
        kernel.rows.append(row)
        print(json.dumps(row), flush=True)


def write_inputs(tmp, torch, np):
    from patchgan_tpu_torch.models import UNet
    from patchgan_tpu_torch.utils.checkpoint import save_state_dict
    shutil.copy(os.path.join(ROOT, 'examples', 'io_plugin_example.py'),
                os.path.join(tmp, 'io.py'))
    data = os.path.join(tmp, 'images')
    os.makedirs(data)
    rng = np.random.default_rng(0)
    sizes = [(960, 1280), (480, 640), (256, 256), (150, 200)]
    for i, (h, w) in enumerate(sizes):
        np.savez(os.path.join(data, f'{i:03d}.npz'),
                 image=rng.random((h, w, IN_C), dtype=np.float32),
                 labels=np.zeros((h, w), np.int32))
    model = UNet(IN_C, OUT_C, nf=NF, activation='relu', final_act='softmax',
                 generator=torch.Generator().manual_seed(0))
    save_state_dict(os.path.join(tmp, 'generator.npz'), model.state_dict())
    cfg = {
        'dataset': {'type': 'NpzSegmentationDataset', 'size': SIZE,
                    'dataset_path': data, 'in_channels': IN_C,
                    'out_channels': OUT_C},
        'model_params': {'gen_filts': NF, 'activation': 'relu',
                         'final_activation': 'softmax'},
        'checkpoint_paths': {'generator':
                             os.path.join(tmp, 'generator.npz')},
        'infer_params': {'output_path': os.path.join(tmp, 'masks'),
                         'threshold': 0, 'overlap': 0.9},
    }
    import yaml
    path = os.path.join(tmp, 'infer.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path, sizes, model


def expected_chunks(sizes):
    from patchgan_tpu_torch.inference.engine import _pick_bucket
    from patchgan_tpu_torch.inference.tiling import crop_positions
    total = 0
    for h, w in sizes:
        hp, wp = max(h, SIZE), max(w, SIZE)
        n = len(crop_positions(hp, wp, SIZE, 0.9))
        bs = _pick_bucket(n, 128)
        total += -(-n // bs)
    return total


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F
    from patchgan_tpu_torch.cli.infer import patchgan_infer
    from patchgan_tpu_torch.ops.kernels import (
        _build, conv_norm_act, conv_norm_act_plain, convt_norm_act,
        convt_norm_act_plain, instance_norm_act, instance_norm_act_plain)

    card = card_line()
    print(f'card: {card}')
    print(f'python {sys.version.split()[0]} torch {torch.__version__} '
          f'cuda {torch.version.cuda}', flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f'build: {time.perf_counter() - t0:.2f} s', flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  ptxas {name}: {line.strip()}')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    kernels = (
        Kernel('instance_norm_act', 'patchgan_tpu_torch/csrc/norm_act.cu',
               'patchgan_tpu/ops/pallas/norm_act.py:211',
               instance_norm_act, instance_norm_act_plain),
        Kernel('conv_norm_act', 'patchgan_tpu_torch/csrc/conv_norm_act.cu',
               'patchgan_tpu/ops/pallas/conv_norm_act.py:176',
               conv_norm_act, conv_norm_act_plain),
        Kernel('convt_norm_act',
               'patchgan_tpu_torch/csrc/convt_norm_act.cu',
               'patchgan_tpu/ops/pallas/convt_norm_act.py:178',
               convt_norm_act, convt_norm_act_plain))
    print('== kernel phase (8 tiles of 256 px, nf=64)', flush=True)
    with torch.inference_mode():
        kernel_phase(torch, F, kernels)

    print('== main path: patchgan_infer -d cuda', flush=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        cfg, sizes, model = write_inputs(tmp, torch, np)
        os.chdir(tmp)
        try:
            for k in kernels:
                k.wrapper.launches = 0
            t0 = time.perf_counter()
            patchgan_infer(['-c', cfg, '-d', 'cuda'])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.name: k.wrapper.launches for k in kernels}
        finally:
            os.chdir(cwd)
        chunks = expected_chunks(sizes)
        print(f'  wall {wall:.2f} s, {chunks} forward chunks, launches '
              f'{launches}', flush=True)
        want = dict(zip([k.name for k in kernels],
                        [chunks, 6 * chunks, 5 * chunks]))
        if launches != want:
            raise AssertionError(f'launches {launches}, expected {want}')
        for i, (h, w) in enumerate(sizes):
            mask = np.load(os.path.join(tmp, 'masks', f'{i:03d}.npy'))
            if mask.shape != (h, w) or mask.min() < 0 or \
                    mask.max() >= OUT_C:
                raise AssertionError(f'mask {i}: shape {mask.shape}, '
                                     f'labels {mask.min()}..{mask.max()}')
            print(f'  mask {i}: {mask.shape}, {len(np.unique(mask))} '
                  f'labels', flush=True)

    print('== full forward, one bucket of 8 tiles', flush=True)
    from patchgan_tpu_torch.inference import InferenceEngine
    tiles = torch.from_numpy(np.random.default_rng(1).random(
        (B, IN_C, SIZE, SIZE), dtype=np.float32))
    model.eval()
    with torch.inference_mode():
        ref = model.to(torch.float32)(tiles)            # plain path, CPU
        gpu32 = InferenceEngine(model, dtype=torch.float32).model
        p32 = gpu32(tiles.cuda()).cpu()
        d32 = (p32 - ref).abs().max().item()
        del gpu32
        eng = InferenceEngine(model, dtype=torch.bfloat16)
        p16 = eng.model(tiles.cuda()).float().cpu()
    d16 = (p16 - ref).abs().max().item()
    agree = (p16.argmax(1) == ref.argmax(1)).float().mean().item()
    print(f'  fp32 kernels vs plain: max |dprob| {d32:.3e} (tol 1e-3)')
    print(f'  bf16 kernels vs fp32 plain: max |dprob| {d16:.3e}, argmax '
          f'agreement {agree:.5f}', flush=True)
    if not d32 <= 1e-3:
        raise AssertionError(f'fp32 forward differs by {d32}')

    print('== throughput (bf16)', flush=True)
    big = np.random.default_rng(2).random((960, 1280, IN_C),
                                          dtype=np.float32)
    for _ in range(3):
        eng.predict_image(big)
    readings = []
    for i in range(WINDOWS):
        count, t0 = 0, time.perf_counter()
        while True:
            eng.predict_image(big)      # .result() waits for the card
            count += 1
            dt = time.perf_counter() - t0
            if dt >= WINDOW_S:
                break
        readings.append(count / dt)
        print(f'  1280x960 window {i}: {count} masks in {dt:.3f} s, '
              f'{readings[-1]:.3f} masks/s', flush=True)
    masks_s = statistics.median(readings)
    print(f'  1280x960: median {masks_s:.3f} masks/s (min {min(readings):.3f}'
          f', max {max(readings):.3f}) over {WINDOWS} windows of >= '
          f'{WINDOW_S} s on {card}')
    rates = {}
    with torch.inference_mode():
        for bs in (8, 32):
            x = torch.rand(bs, IN_C, SIZE, SIZE, device='cuda')
            ms = cuda_ms(lambda: eng.model(x), iters=10, warmup=2)
            rates[bs] = bs / ms * 1e3
            print(f'  forward bucket {bs}: {ms:.3f} ms, {rates[bs]:.1f} '
                  f'tiles/s on {card}', flush=True)
    print(json.dumps({'masks_per_s_1280x960': masks_s,
                      'masks_per_s_windows': readings,
                      'tiles_per_s': rates, 'card': card}))

    summary = []
    for k in kernels:
        summary.append({
            'name': k.name, 'route': 'cuda', 'source': k.source,
            'replaces': k.replaces, 'launches': launches[k.name],
            'max_abs_err': max(r['max_abs_err_bf16'] for r in k.rows),
            'ms': sum(r['kernel_ms'] for r in k.rows),
            'plain_ms': sum(r['plain_ms'] for r in k.rows),
            'bound_ms': sum(r['bound_ms'] for r in k.rows),
            'bound_by': max(k.rows, key=lambda r: r['bound_ms'])['bound_by'],
            'library_ms': sum(r['library_ms'] for r in k.rows)})
    print(json.dumps({'kernels': summary}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
