#!/usr/bin/env python3
"""Drive the PyTorch port (``patchgan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository. In order:

1. prints the card's name and power limit, the torch / CUDA versions, and
   builds every kernel from ``patchgan_tpu_torch/csrc`` (one nvcc per
   source, all at once), with the build time;
2. kernel phase: each forward kernel (K1 instance norm + act, K2 conv +
   IN + act, K3 convT + IN + act) at every shape the nf=64 generator
   gives it for 8 tiles of 256 px, in bf16 and fp32, against its plain
   PyTorch version on the same inputs with TF32 off. Tolerances: fp32
   inputs, atol 1e-3 (another summation order); bf16 inputs against the
   plain version in fp32 on the same bf16-rounded inputs, atol 3e-2 (one
   bf16 rounding of outputs of magnitude up to ~5). K3 also runs a case
   with H != W and a ragged one (13 + 6 input channels, so K = 76 is no
   multiple of 8 and one K step holds x, skip and the zero-filled tail;
   40 output channels; 12 x 20), and every kernel all four activations at
   one shape. K3's weight pack kernel is held exactly against
   ``pack_convt_weight_plain`` at every K3 case, in both dtypes. K1 also
   runs check-only cases at the edges of its launch classes
   (``norm_edge_cases``: planes of 16, 64, 256, 1024, 4096 and 65536
   elements, a plane count no multiple of a block's planes, 1x1, 1x3 and
   6x10 planes, inputs one element past a 16-byte boundary; all four
   activations at 4x4), and two launches on the same inputs must give
   equal bits. Times (CUDA events): the kernel, its plain version, and a
   library yardstick (cuDNN conv + F.instance_norm + activation, which
   the port never calls), beside the bound max(FLOPs / peak, bytes / 3.35
   TB/s); K1's row also carries its device time (a CUDA graph's
   replay, without the wrapper's host work) and launch geometry;
   then K4 (the thin 3x3 conv of the s2d boundary form) and K4-wgrad (its
   weight gradient) at every shape of the s2d paths: enc0 of an 8-tile
   inference chunk (12 -> 64 channels on the 128 x 128 s2d grid), the
   batch-16 step's enc0 / discriminator conv0 image part (12 -> 64) and
   mask part (28 -> 64), the merged 32-sample validation discriminator,
   and four cases checked only: a ragged one (4 -> 28 channels on 40 x
   70, a width that is no multiple of the 64-wide tile or of 8, so both
   kernels stage x and dy element by element and K4 stores its output so),
   an aligned partial one (20 -> 40 on 24 x 72: a width that is a multiple
   of 8 but not of 64, so the 16-byte staging runs with chunks past the
   image; a half-empty 8-channel group; Cout under one block), one with
   fewer tiles than the persistent grid (12 -> 64 on 6 x 8) and the
   widest input (32 -> 64 on 16 x 64). K4 tolerances as K2's; K4-wgrad
   (fp32 output) 1e-3 max(1, max |dw|) in both dtypes; K4's weight pack
   kernel exactly equal to ``pack_thin_weight_plain`` at every case, in
   both dtypes. Each timed row carries the grid (blocks along the tiles)
   and the blocks an SM holds. Library yardsticks F.conv2d and
   torch.nn.grad.conv2d_weight in bf16;
3. the inference path: ``patchgan_infer -d cuda`` (bf16) with a random
   nf=64 3 -> 7-class generator on four images (1280x960, 640x480,
   256x256, 200x150), checking each mask's shape and labels, and that
   K1, K2 and K3 ran 1, 6 and 5 times per forward chunk; then the same
   with ``PATCHGAN_S2D=on`` (the space-to-depth boundary form), where K4
   also runs once per chunk;
4. the full nf=64 forward on one bucket of 8 tiles: the kernel path in
   fp32, plain and s2d form, against the plain path (the same model on
   the CPU), max |dprob| <= 1e-3; the bf16 kernel path against it,
   reported;
5. masks/s for the 1280x960 image, one image at a time, in windows of at
   least 2 s, five per form, plain and s2d in turns (every reading and
   the medians), and tiles/s of the forward at buckets 8 and 32 in both
   forms;
6. K1-bwd (the instance norm + act backward) at the 12 shapes of one
   generator backward at batch 16, 256 px, nf=64, in bf16 and fp32, plus
   all four activations at one shape, an H != W case and planes whose
   middle value normalises to exactly 0, against the plain backward on
   the same inputs (fp32 max |err| <= 1e-3 max(1, max |dx|); bf16
   against the fp32 plain version on the bf16-rounded inputs, <= 3e-2
   max(1, max |dx|)), then K1's edge cases (both dtypes, all four
   activations at 4x4) and the equal-bits check of two launches. Times:
   kernel (CUDA events, host work included), its device time (a CUDA
   graph's replay),
   plain, and ATen's backward of F.instance_norm + relu through
   torch.autograd.grad (never called by the port), beside the bytes
   bound, with each level's launch geometry (class, grid, group);
7. step parity, plain form and s2d form: one G+D loss and the generator's
   and discriminator's gradients at nf=64, 256 px, batch 2, fp32, TF32
   off, dropout off, from the same weights and batch, through the kernel
   path on the card and the plain path on the CPU: losses within rtol
   2e-3 / atol 2e-4, every gradient within 1e-3 of that tensor's max
   |g|; then the fine-tune step's parity: the encoder frozen
   (``('enc',)``), accumulation every 2, two fp32 micro-batches of 2 on
   both devices: losses as above, the card's gradients of each
   micro-step within 1e-4 of each tensor's max |g| of its full step's
   on the same weights and batch, the first's within 1e-3 of the CPU's
   (the second's printed: ``finetune_parity_phase`` says why), the mean
   the second hands Adam the running mean of the two, no parameter
   moved after the first, the encoder bit-equal to its initial weights
   after the second on both devices, every other parameter within Adam's sign-flip bound of the
   CPU's (``assert_update_close``);
8. the training path: ``patchgan_train -d cuda`` (bf16, batch 16, 2
   epochs, nf=64 / ndf=64, 256 px, tversky * 200 + BCE) on a synthetic
   npz folder (64 training and 16 validation images, 7 classes), then a
   resume with ``load_last_checkpoint`` to epoch 3: finite losses, all
   four epoch files, the resume at epoch 3 with the fast-forwarded LR,
   and K1 / K2 / K3 / K1-bwd at 1 / 6 / 5 / 12 launches per train step
   (1 / 6 / 5 / 0 per validation batch) and 11 K2 / K3 recomputes; then
   the fine-tune of BASELINE.json config 3 (``FT_STEP``): the epoch-3
   weights as torch .pth files, ``transfer_learn.freeze_encoder``,
   ``accumulate_steps: 2``, one epoch: K1-bwd 5 a step, no K2
   recompute, the encoder bit-equal to the .pth; all of it again under
   ``PATCHGAN_S2D=on``, where a train step also launches K4 6 times and
   K4-wgrad 4 times (3 in the fine-tune: the frozen enc0 takes none) and
   a validation batch K4 5 times;
9. the evaluation path: ``patchgan_eval -d cuda`` (bf16, batch 8) with
   the training config on its 16 validation images, so the newest epoch
   file is evaluated: the JSON line's keys, n_images 16, values in [0,
   1], K1 / K2 / K3 1 / 6 / 5 a batch; ``-d cuda --dtype float32``
   against ``-d cpu --dtype float32``, IoU, Dice and boundary F1 within
   2e-3; then images/s of the bf16 loop on ``EVAL_TIMED`` seeded images
   (batch 8, the first batch left out), in two runs;
10. training img/s of the bf16 step on a device-resident batch, in
   turns, five windows of at least 2 s each (every reading and the
   medians): the full step at batch 16 in the plain and the s2d form,
   the fine-tune step (encoder frozen) in both forms, and the fine-tune
   step accumulating two micro-batches of 8; peak device memory, and a
   profiler breakdown of three steps of each (the top kernels, then each
   of the port's kernels, and the device kernels launched a step, fewer
   for a frozen step than a full one of its form).

It prints a JSON summary of the kernels (launches from the s2d training
run, which drives all six; every path's counts beside them), the card's
name and power limit, and as its last line ``{"ok": true, "device":
{...}}``. Any failure exits non-zero before that line; without a CUDA
device it exits 2.
"""

import contextlib
import copy
import io
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
WINDOWS, WINDOW_S = 5, 2.0   # masks/s, img/s: timing windows, seconds each
TRAIN_B, NDF = 16, 64        # training batch, discriminator width
TOL_BWD = {'float32': 1e-3, 'bfloat16': 3e-2}   # times max(1, max |dx|)
# fp32 operations per element of K1-bwd: statistics 3, the two sums 6,
# dx 5 (act' counted as one)
BWD_FLOPS = 14
# launches of K1, K2, K3, K1-bwd, K4, K4-wgrad per train step and per
# validation batch. s2d step: K4 6 = enc0 1 + the fake conv0's image and
# mask parts inside G's loss 2 + the paired D step's shared image part
# and two mask parts 3; K4-wgrad 4 = enc0 1 + the D step's three parts
# (D's weights are constants in G's loss, so its conv0 takes no weight
# gradient there; the dec6 head's Cin = 64 convs run in cuDNN). s2d
# validation: K4 5 = enc0 1 + the fake pair in G's loss 2 + the merged
# real and fake pair 2.
STEP = {'off': [1, 6, 5, 12, 0, 0], 'on': [1, 6, 5, 12, 6, 4]}
EVAL = {'off': [1, 6, 5, 0, 0, 0], 'on': [1, 6, 5, 0, 5, 0]}
# the same per fine-tune step with the encoder frozen ('enc',): the
# encoder runs forward only, so K1-bwd runs at dec1-dec5 alone, K2 takes
# no recompute, and the s2d enc0's K4 takes no weight gradient (the
# discriminator's three conv0 parts still do)
FREEZE = ('enc',)
FT_STEP = {'off': [1, 6, 5, 5, 0, 0], 'on': [1, 6, 5, 5, 6, 3]}
# K2 + K3 recomputes (recompute_grads) per full and per frozen step
RECOMPUTES = {'full': 6 + 5, 'frozen': 5}
LR = 1e-3
EVAL_TIMED = 384   # images of the folder the eval loop is timed on


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


def device_ms(fn, iters=20):
    """Time per call on the card without the host's share: CUDA events
    around the replay of a CUDA graph of ``iters`` calls (captured after
    a warm-up on a side stream); the card's gaps between launches are
    included."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def norm_geometry(shape, dtype):
    """K1's / K1-bwd's launch geometry at an (N, C, H, W) shape, for a
    timed row."""
    from patchgan_tpu_torch.ops.kernels.norm_act import plane_geometry
    n, c, h, w = shape
    return plane_geometry(n * c, h * w, dtype)._asdict()


def norm_edge_cases(torch, gen):
    """(label, pair) at the instance-norm kernels' edge shapes, where
    pair(dtype) gives (x, g) in that dtype: planes of each launch class's
    edge, a plane count no multiple of the planes a block takes, planes of
    3 and 60 elements (no multiple of 16 bytes in bf16: element by
    element), planes larger than the registers hold (read again from
    memory), and x, g one element past a 16-byte boundary (element by
    element)."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device='cuda')

    out = []
    for shape in ((3, 5, 4, 4), (2, 8, 8, 8), (2, 4, 16, 16), (2, 8, 1, 3),
                  (2, 8, 6, 10), (1, 33, 32, 32), (1, 3, 64, 64),
                  (4, 8, 1, 1), (2, 3, 256, 256)):
        x, g = rand(*shape), rand(*shape)
        out.append((f'{shape}', lambda dt, x=x, g=g: (x.to(dt), g.to(dt))))
    shape = (2, 8, 16, 16)
    x, g = rand(2 * 8 * 16 * 16 + 1), rand(2 * 8 * 16 * 16 + 1)
    out.append((f'{shape} one element past 16 bytes',
                lambda dt: (x.to(dt)[1:].view(shape),
                            g.to(dt)[1:].view(shape))))
    return out


@contextlib.contextmanager
def s2d_env(flag):
    """PATCHGAN_S2D set to ``flag`` ('on' or 'off') for the block."""
    old = os.environ.get('PATCHGAN_S2D')
    os.environ['PATCHGAN_S2D'] = flag
    try:
        yield
    finally:
        if old is None:
            os.environ.pop('PATCHGAN_S2D')
        else:
            os.environ['PATCHGAN_S2D'] = old


@contextlib.contextmanager
def in_dir(path):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


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
              ('H!=W', 24, 40, 2 * NF, 2 * NF, NF),
              ('ragged', 12, 20, 13, 6, 40)]
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


def repeat_check(torch, wrapper, args_of, gen):
    """Two launches on the same inputs give the same bits (fixed-order
    reductions, no atomics), in both dtypes, at one plane of each launch
    class: lanes (16 x 16), block (128 x 128), stream (256 x 256)."""
    for shape in ((16, 512, 16, 16), (16, 64, 128, 128), (2, 3, 256, 256)):
        x = torch.randn(*shape, generator=gen, device='cuda')
        g = torch.randn(*shape, generator=gen, device='cuda')
        for dt in (torch.bfloat16, torch.float32):
            args = args_of(x.to(dt), g.to(dt))
            a, b = wrapper(*args), wrapper(*args)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f'{wrapper.__name__} {shape} {dt}: two '
                                     f'launches differ')
        print(f'  {wrapper.__name__} {shape}: two launches equal in bf16 '
              f'and fp32', flush=True)


def kernel_phase(torch, F, kernels):
    from patchgan_tpu_torch.ops.kernels import (pack_convt_weight,
                                                pack_convt_weight_plain)

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
            if kernel.name == 'convt_norm_act':
                w = make(dt)[1]
                if not torch.equal(pack_convt_weight(w),
                                   pack_convt_weight_plain(w)):
                    raise AssertionError(f'K3 pack {label} {dname} differs')
                print(f'  K3 pack {label} {dname}: equal', flush=True)
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
        if label.startswith(('H!=W', 'ragged')):
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
        if kernel.name == 'instance_norm_act':
            row.update(device_ms=device_ms(lambda: kernel.wrapper(*args)),
                       **norm_geometry(args[0].shape, torch.bfloat16))
        kernel.rows.append(row)
        print(json.dumps(row), flush=True)
    k1 = kernels[0]
    gen = torch.Generator(device='cuda').manual_seed(11)
    for label, pair in norm_edge_cases(torch, gen):
        for dname, dt in (('bfloat16', torch.bfloat16),
                          ('float32', torch.float32)):
            x = pair(dt)[0]
            for act in (ACTS if label == '(3, 5, 4, 4)' else ('relu',)):
                e = err(k1, (x.float(), 1e-5, act), (x, 1e-5, act))
                print(f'  {k1.name} edge {label} {dname} act={act}: '
                      f'max_abs_err {e:.3e} (tol {TOL[dname]:.0e})',
                      flush=True)
                if not e <= TOL[dname]:
                    raise AssertionError(f'{k1.name} edge {label} {dname} '
                                         f'act={act}: {e} > {TOL[dname]}')
    repeat_check(torch, k1.wrapper, lambda xd, gd: (xd, 1e-5, 'relu'), gen)


def thin_conv_phase(torch, F, k4, k4w):
    """K4 and K4-wgrad against their plain versions at the s2d paths'
    shapes, bf16 and fp32, and K4's weight pack against its plain
    layout; timing rows go to ``k4.rows`` / ``k4w.rows`` with ``calls``,
    the number of calls per train step at that shape (0: the inference
    chunk and the merged validation discriminator, where K4-wgrad is
    checked but not timed)."""
    from patchgan_tpu_torch.ops.kernels import (pack_thin_weight,
                                                pack_thin_weight_plain)
    from patchgan_tpu_torch.ops.kernels.thin_conv import thin_conv_grid
    gen = torch.Generator(device='cuda').manual_seed(9)
    hw = SIZE // 2
    # (label, N, Cin, H, W, Cout, K4 calls per step, K4-wgrad calls,
    # timed)
    cases = [('enc0 infer chunk', B, 4 * IN_C, hw, hw, NF, 0, 0, True),
             ('enc0 / D conv0 image', TRAIN_B, 4 * IN_C, hw, hw, NF, 3, 2,
              True),
             ('D conv0 mask', TRAIN_B, 4 * OUT_C, hw, hw, NDF, 3, 2, True),
             ('val D image', 2 * TRAIN_B, 4 * IN_C, hw, hw, NDF, 0, 0, True),
             ('val D mask', 2 * TRAIN_B, 4 * OUT_C, hw, hw, NDF, 0, 0, True),
             ('ragged', 3, 4, 40, 70, 28, 0, 0, False),
             ('aligned partial', 2, 20, 24, 72, 40, 0, 0, False),
             ('few tiles', 1, 12, 6, 8, 64, 0, 0, False),
             ('max Cin', 4, 32, 16, 64, 64, 0, 0, False)]
    for label, n, cin, h, wd, cout, fcalls, wcalls, timed in cases:
        label = f'{label} ({n}, {cin}, {h}, {wd}) -> {cout}'
        x = torch.randn(n, cin, h, wd, generator=gen, device='cuda')
        # O(1) outputs, as the layers' xavier weights give
        w = torch.randn(cout, cin, 3, 3, generator=gen, device='cuda') * \
            0.5 / (9 * cin) ** 0.5
        dy = torch.randn(n, cout, h, wd, generator=gen, device='cuda')
        errs = {}
        for dname, dt in (('bfloat16', torch.bfloat16),
                          ('float32', torch.float32)):
            xd, wd_, dyd = x.to(dt), w.to(dt), dy.to(dt)
            if not torch.equal(pack_thin_weight(wd_),
                               pack_thin_weight_plain(wd_, dt)):
                raise AssertionError(f'K4 pack {label} {dname} differs')
            got = k4.wrapper(xd, wd_).float()
            want = k4.plain(xd.float(), wd_.float())
            got_w = k4w.wrapper(xd, dyd)
            want_w = k4w.plain(xd.float(), dyd.float())
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            ew = (got_w - want_w).abs().max().item()
            tol_w = 1e-3 * max(1.0, want_w.abs().max().item())
            print(f'  {k4.name} {label} {dname}: max_abs_err {e:.3e} (tol '
                  f'{TOL[dname]:.0e}); {k4w.name}: {ew:.3e} (tol '
                  f'{tol_w:.3e}); pack equal', flush=True)
            if not (e <= TOL[dname] and ew <= tol_w):
                raise AssertionError(f'thin conv {label} {dname}: {e}, {ew}')
            errs[dname] = (e, ew)
        if not timed:
            continue
        xb, wb, dyb = x.bfloat16(), w.bfloat16(), dy.bfloat16()
        flops = 2 * n * h * wd * 9 * cin * cout
        xy = 2 * (x.numel() + dy.numel())
        for k, calls, (fn, plain, lib), nbytes, i in (
                (k4, fcalls, (lambda: k4.wrapper(xb, wb),
                              lambda: k4.plain(xb, wb),
                              lambda: F.conv2d(xb, wb, padding=1)),
                 xy + 2 * w.numel(), 0),
                (k4w, wcalls, (lambda: k4w.wrapper(xb, dyb),
                               lambda: k4w.plain(xb, dyb),
                               lambda: torch.nn.grad.conv2d_weight(
                                   xb, wb.shape, dyb, padding=1)),
                 xy + 4 * w.numel(), 1)):
            if k is k4w and not calls:
                continue   # no backward at this shape on any path
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
            grid, per_sm = thin_conv_grid(xb, cout, wgrad=k is k4w)
            row = {'kernel': k.name, 'case': label, 'dtype': 'bfloat16',
                   'calls': calls, 'grid': grid, 'blocks_per_sm': per_sm,
                   'kernel_ms': cuda_ms(fn),
                   'plain_ms': cuda_ms(plain), 'library_ms': cuda_ms(lib),
                   'bound_ms': b_ms, 'bound_by': b_by,
                   'max_abs_err_bf16': errs['bfloat16'][i],
                   'max_abs_err_fp32': errs['float32'][i]}
            k.rows.append(row)
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


def bwd_shapes():
    """(level, (N, C, H, W)) of the 12 K1-bwd calls of one generator
    backward at batch 16, 256 px, nf=64: x is each normed level's
    pre-norm tensor."""
    b, f = TRAIN_B, NF
    out = [('enc0', (b, f, 128, 128))]
    for lvl, (c, hw) in enumerate([(2 * f, 64), (4 * f, 32), (8 * f, 16),
                                   (8 * f, 8), (8 * f, 4), (8 * f, 2)], 1):
        out.append((f'enc{lvl}', (b, c, hw, hw)))
    for lvl, (c, hw) in enumerate([(8 * f, 8), (8 * f, 16), (4 * f, 32),
                                   (2 * f, 64), (f, 128)], 1):
        out.append((f'dec{lvl}', (b, c, hw, hw)))
    return out


def backward_phase(torch, F, kernel):
    """K1-bwd against its plain version at the training shapes; timing
    rows go to ``kernel.rows``."""
    gen = torch.Generator(device='cuda').manual_seed(3)

    def rand(shape):
        return torch.randn(*shape, generator=gen, device='cuda')

    def check(label, x, g, act, pair=None):
        errs = {}
        for dname, dt in (('bfloat16', torch.bfloat16),
                          ('float32', torch.float32)):
            xd, gd = pair(dt) if pair else (x.to(dt), g.to(dt))
            got = kernel.wrapper(gd, xd, 1e-5, act).float()
            want = kernel.plain(gd.float(), xd.float(), 1e-5, act)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = TOL_BWD[dname] * max(1.0, want.abs().max().item())
            print(f'  {kernel.name} {label} {dname} act={act}: max_abs_err '
                  f'{e:.3e} (tol {tol:.3e})', flush=True)
            if not e <= tol:
                raise AssertionError(f'{kernel.name} {label} {dname} '
                                     f'act={act}: {e} > {tol}')
            errs[dname] = e
        return errs

    for label, shape in bwd_shapes():
        x, g = rand(shape), rand(shape)
        errs = check(f'{label} {shape}', x, g, 'relu')
        args = (g.bfloat16(), x.bfloat16(), 1e-5, 'relu')
        k_ms = cuda_ms(lambda: kernel.wrapper(*args))
        p_ms = cuda_ms(lambda: kernel.plain(*args))
        xr = args[1].clone().requires_grad_()
        y = F.relu(F.instance_norm(xr, eps=1e-5))
        lib_ms = cuda_ms(lambda: torch.autograd.grad(y, xr, args[0],
                                                     retain_graph=True))
        numel = x.numel()
        b_ms, b_by = bound(BWD_FLOPS * numel, 3 * 2 * numel, PEAK_FP32)
        row = {'kernel': kernel.name, 'case': f'{label} {shape}',
               'dtype': 'bfloat16', 'kernel_ms': k_ms,
               'device_ms': device_ms(lambda: kernel.wrapper(*args)),
               'plain_ms': p_ms, 'library_ms': lib_ms, 'bound_ms': b_ms,
               'bound_by': b_by, 'max_abs_err_bf16': errs['bfloat16'],
               'max_abs_err_fp32': errs['float32'],
               **norm_geometry(shape, torch.bfloat16)}
        kernel.rows.append(row)
        print(json.dumps(row), flush=True)
    total = {k: sum(r[k] for r in kernel.rows)
             for k in ('kernel_ms', 'device_ms', 'bound_ms')}
    print(f'  {kernel.name}, the 12 calls: kernel_ms {total["kernel_ms"]:.4f}'
          f', device_ms {total["device_ms"]:.4f}, bound_ms '
          f'{total["bound_ms"]:.4f}', flush=True)
    x, g = rand((TRAIN_B, 4 * NF, 32, 32)), rand((TRAIN_B, 4 * NF, 32, 32))
    for act in ACTS:
        check('dec3 shape', x, g, act)
    x, g = rand((TRAIN_B, NF, 24, 40)), rand((TRAIN_B, NF, 24, 40))
    check('H!=W (16, 64, 24, 40)', x, g, 'leakyrelu')
    # (-a, 0, a) planes: the middle xhat is exactly 0, where relu' = 0
    # and leakyrelu' = 1
    a = rand((TRAIN_B, NF, 1, 1)).abs() + 0.5
    x = torch.cat([-a, 0 * a, a], dim=3)
    g = rand((TRAIN_B, NF, 1, 3))
    for act in ACTS:
        check('xhat=0 (16, 64, 1, 3)', x, g, act)
    for label, pair in norm_edge_cases(torch, gen):
        for act in (ACTS if label == '(3, 5, 4, 4)' else ('relu',)):
            check(f'edge {label}', None, None, act, pair)
    repeat_check(torch, kernel.wrapper,
                 lambda xd, gd: (gd, xd, 1e-5, 'relu'), gen)


def train_batch(torch, np, n, size, device, seed):
    """A seeded NCHW (image, one-hot mask) batch of OUT_C classes."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((n, IN_C, size, size),
                                    dtype=np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, OUT_C, (n, size, size)))
    y = torch.nn.functional.one_hot(labels, OUT_C).permute(0, 3, 1, 2)
    return x, y.float().contiguous().to(device)


def step_grads(torch, g, d, x, y, s2d):
    """One G+D loss and the generator's and discriminator's gradients
    (tversky * 200 + BCE, the paired D) in the form ``s2d`` ('on' or
    'off') selects, without an update: (losses, gradients in float64 on
    the host)."""
    from patchgan_tpu_torch.ops.s2d import space_to_depth
    from patchgan_tpu_torch.train.steps import (
        constant_params, disc_loss, disc_real_fake, gan_losses,
        make_seg_loss, resolve_paired_disc)
    form = s2d == 'on'
    if form:
        x, y = space_to_depth(x), space_to_depth(y)
    with constant_params(d.parameters()):
        g_loss, gen_img, gdisc = gan_losses(
            g, d, make_seg_loss('tversky', 200.0), x, y, form)
    g_grads = torch.autograd.grad(g_loss, list(g.parameters()))
    d_loss, real, fake = disc_loss(*disc_real_fake(
        d, x, y, gen_img.detach(), merged=False,
        paired=resolve_paired_disc(d), s2d=form))
    d_grads = torch.autograd.grad(d_loss, list(d.parameters()))
    losses = {'gen': g_loss, 'gdisc': gdisc, 'discr': real,
              'discf': fake, 'disc': d_loss}
    return ({k: v.item() for k, v in losses.items()},
            [t.double().cpu() for t in g_grads + d_grads])


def step_parity_phase(torch, np, wrappers, s2d):
    """One G+D loss and the generator's and discriminator's gradients in
    the form ``s2d`` ('on' or 'off') selects, kernel path on the card
    against the plain path on the CPU, fp32, TF32 off, dropout off."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    init = torch.Generator().manual_seed(4)
    gen = UNet(IN_C, OUT_C, nf=NF, activation='relu', final_act='softmax',
               generator=init)
    disc = Discriminator(IN_C + OUT_C, ndf=NDF, n_layers=3, generator=init)
    x, y = train_batch(torch, np, 2, SIZE, 'cpu', 5)
    t0 = time.perf_counter()
    cpu_losses, cpu_grads = step_grads(torch, gen, disc, x, y, s2d)
    cpu_s = time.perf_counter() - t0
    gen_c, disc_c = copy.deepcopy(gen).cuda(), copy.deepcopy(disc).cuda()
    for w in wrappers:
        w.launches = 0
    gpu_losses, gpu_grads = step_grads(torch, gen_c, disc_c, x.cuda(),
                                       y.cuda(), s2d)
    launches = [w.launches for w in wrappers]
    print(f'  s2d {s2d}: plain path on the CPU {cpu_s:.1f} s; launches on '
          f'the card {launches}', flush=True)
    if launches != STEP[s2d]:
        raise AssertionError(f'step parity launches {launches}, expected '
                             f'{STEP[s2d]}')
    for k, want in cpu_losses.items():
        got = gpu_losses[k]
        ok = abs(got - want) <= 2e-4 + 2e-3 * abs(want)
        print(f'  loss {k}: card {got:.7g}, CPU {want:.7g}'
              f'{"" if ok else "  FAIL"}', flush=True)
        if not ok:
            raise AssertionError(f'loss {k}: {got} vs {want}')
    worst = {}
    names = [f'G {n}' for n, _ in gen.named_parameters()] + \
        [f'D {n}' for n, _ in disc.named_parameters()]
    for name, got, want in zip(names, gpu_grads, cpu_grads):
        rel = (got - want).abs().max().item() / max(
            want.abs().max().item(), 1e-30)
        worst[name[0]] = max(worst.get(name[0], 0.0), rel)
        if not rel <= 1e-3:
            raise AssertionError(f'grad {name}: {rel:.3e} of max |g|')
    print(f'  gradients: worst max |dg| / max |g| generator {worst["G"]:.3e}'
          f', discriminator {worst["D"]:.3e} (tol 1e-3) over '
          f'{len(gpu_grads)} tensors', flush=True)
    return worst


class Tee(io.StringIO):
    """Keeps what is printed and passes it on to the real stdout."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def write_npz_folder(path, np, rng, n):
    """``n`` seeded (image, labels) files for the npz plugin."""
    os.makedirs(path)
    for i in range(n):
        np.savez(os.path.join(path, f'{i:03d}.npz'),
                 image=rng.random((SIZE, SIZE, IN_C), dtype=np.float32),
                 labels=rng.integers(1, OUT_C + 1, (SIZE, SIZE))
                 .astype(np.int32))


def write_train_inputs(tmp, np):
    shutil.copy(os.path.join(ROOT, 'examples', 'io_plugin_example.py'),
                os.path.join(tmp, 'io.py'))
    rng = np.random.default_rng(6)
    for split, n in (('train', 64), ('val', 16)):
        write_npz_folder(os.path.join(tmp, split), np, rng, n)
    cfg = {
        'dataset': {'type': 'NpzSegmentationDataset', 'size': SIZE,
                    'in_channels': IN_C, 'out_channels': OUT_C,
                    'labels': list(range(1, OUT_C + 1)),
                    'train_data': {'images': 'train', 'masks': 'train'},
                    'validation_data': {'images': 'val', 'masks': 'val'}},
        'model_params': {'generator': {'filters': NF, 'activation': 'relu',
                                       'final_activation': 'softmax'},
                         'discriminator': {'filters': NDF, 'n_layers': 3}},
        'checkpoint_path': os.path.join(tmp, 'ck'),
        'train_params': {'loss_type': 'tversky', 'seg_alpha': 200,
                         'gen_learning_rate': 1e-3,
                         'disc_learning_rate': 1e-3, 'decay_rate': 0.5,
                         'save_freq': 1},
    }
    import yaml
    paths = []
    for name, resume in (('train.yaml', False), ('resume.yaml', True)):
        cfg['load_last_checkpoint'] = resume
        paths.append(os.path.join(tmp, name))
        with open(paths[-1], 'w') as f:
            yaml.safe_dump(cfg, f)
    return paths


def train_path_phase(torch, np, wrappers, card, s2d, tmp):
    """patchgan_train -d cuda for 2 epochs, then a resume to epoch 3,
    under PATCHGAN_S2D=``s2d``, on a synthetic folder written into
    ``tmp``; returns the launch counts of the first run, the epoch times
    and the training config."""
    from patchgan_tpu_torch.cli.train import patchgan_train
    from patchgan_tpu_torch.ops.kernels.conv_norm_act import recompute_grads
    per_step, per_eval = STEP[s2d], EVAL[s2d]
    runs = []
    train_cfg, resume_cfg = write_train_inputs(tmp, np)
    with in_dir(tmp):
        for cfg, epochs in ((train_cfg, 2), (resume_cfg, 3)):
            for w in wrappers + [recompute_grads]:
                w.launches = 0
            tee = Tee(sys.stdout)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee), s2d_env(s2d):
                g_hist, d_hist = patchgan_train(
                    ['-c', cfg, '-n', str(epochs), '-b', str(TRAIN_B),
                     '-d', 'cuda', '--no-summary'])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append(([w.launches for w in wrappers], g_hist, d_hist,
                         tee.getvalue(), wall, recompute_grads.launches))
    files = sorted(os.listdir(os.path.join(tmp, 'ck')))
    want_files = [f'{p}_ep_{e:03d}.npz' for p in ('discriminator',
                                                   'generator')
                  for e in (1, 2, 3)]
    if files != want_files:
        raise AssertionError(f'checkpoints {files}, expected {want_files}')
    epoch_s = []
    for (launches, g_hist, d_hist, out, wall, recomputes), epochs in zip(
            runs, (2, 1)):
        steps, evals = 4 * epochs, epochs     # 64 / 16 and 16 / 16
        want = [steps * a + evals * b for a, b in zip(per_step, per_eval)]
        print(f'  run of {epochs} epoch(s): wall {wall:.2f} s, launches '
              f'{launches} (expected {want}), recomputes {recomputes} '
              f'(expected {steps * RECOMPUTES["full"]}), G losses {g_hist}, '
              f'D losses {d_hist}', flush=True)
        if launches != want or recomputes != steps * RECOMPUTES['full']:
            raise AssertionError(f'launches {launches}, expected {want}; '
                                 f'recomputes {recomputes}')
        if not all(np.isfinite(g_hist + d_hist)) or \
                len(g_hist) != epochs:
            raise AssertionError(f'losses {g_hist} {d_hist}')
        for line in out.splitlines():
            if ' images in ' in line:
                epoch_s.append(float(line.split(' images in ')[1]
                                     .split('s')[0]))
    resumed = runs[1][3]
    lr = 1e-3 * 0.5 ** (2 / 5)
    if f'Epoch 3 -- lr: {lr:5.3e}, {lr:5.3e}' not in resumed or \
            'Epoch 1' in resumed or 'Epoch 2' in resumed:
        raise AssertionError('the resume did not start at epoch 3 with the '
                             'fast-forwarded LR')
    print(f'  s2d {s2d}: resumed at epoch 3 with lr {lr:5.3e}; training '
          f'epoch wall times (64 images, loader included) {epoch_s} s on '
          f'{card}', flush=True)
    return runs[0][0], epoch_s, train_cfg


def assert_update_close(name, got, want):
    """Parameters after one Adam update, card against CPU: an element
    whose gradient is at rounding-noise level can flip its update's sign
    (about lr * sign(g)), so 99.9% of the elements within 5e-5 + 5e-3 |w|
    and every one within 2.5 lr (tests/torch_parity.py)."""
    diff = (got - want).abs()
    tight = (diff <= 5e-5 + 5e-3 * want.abs()).float().mean().item()
    worst = diff.max().item()
    if not (tight >= 0.999 and worst <= 2.5 * LR):
        raise AssertionError(f'{name}: {1 - tight:.3%} loose, max diff '
                             f'{worst:.3e}')
    return 1.0 - tight, worst


def record_grads(opt, micro, applied):
    """Make ``opt`` (a ``MultiSteps``) copy to the host the gradients of
    each call, appended to ``micro``, and the mean its k-th call hands its
    inner Adam, appended to ``applied``."""
    outer_step, inner_step = opt.step, opt.inner.step

    def host(grads):
        return [g.detach().float().cpu().clone() for g in grads]

    def step(grads):
        micro.append(host(grads))
        outer_step(grads)

    def inner(grads):
        applied.append(host(grads))
        inner_step(grads)
    opt.step, opt.inner.step = step, inner


def grad_errors(names, got, ref):
    """{name: max |got - ref| / max |ref|} over a list of gradients."""
    return {n: (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
            for n, g, r in zip(names, got, ref)}


def worst_error(errors):
    """The largest of ``grad_errors`` as '<share> (<name>)'."""
    name = max(errors, key=errors.get)
    return f'{errors[name]:.3e} ({name})'


def finetune_parity_phase(torch, np, wrappers, s2d):
    """Two micro-steps of the frozen (('enc',)) step with accumulation
    every 2, fp32, TF32 off, dropout off, in the form ``s2d`` selects:
    the kernel path on the card against the plain path on the CPU from
    the same weights and batches. Losses of both micro-steps within rtol
    2e-3 / atol 2e-4. The gradients of the trained tensors: on the card,
    each micro-step's within 1e-4 of each tensor's max |g| of the full
    step's (``step_grads``, every parameter trainable) on the same
    weights and batch, so a frozen step that drops or scales a term
    fails; the first micro-step's, on phase 7's batch, within 1e-3 of
    the CPU's, phase 7's limit. The second's card-vs-CPU distance is
    printed, not held: with ReLU the step's gradient is not continuous
    at rounding scale (``tools/grad_sensitivity.py``), and this batch
    puts a ReLU input at a deep level on the other side of 0 on the two
    devices. On each device
    the mean the second micro-step hands Adam within 1e-6 of its max of
    the running mean of the two; after the first no parameter has moved
    on either device; after the second the encoder is bit-equal to its
    initial weights on both, every other parameter within Adam's
    sign-flip bound of the CPU's (``assert_update_close``); 2 x
    ``FT_STEP`` launches."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train.steps import (make_optimizer,
                                                make_train_step,
                                                trainable_params)
    init = torch.Generator().manual_seed(4)
    gen = UNet(IN_C, OUT_C, nf=NF, activation='relu', final_act='softmax',
               generator=init)
    disc = Discriminator(IN_C + OUT_C, ndf=NDF, n_layers=3, generator=init)
    names = [f'G {n}' for n, _ in gen.named_parameters()] + \
        [f'D {n}' for n, _ in disc.named_parameters()]
    start = [p.detach().clone() for p in list(gen.parameters())
             + list(disc.parameters())]
    batches = [train_batch(torch, np, 2, SIZE, 'cpu', seed)
               for seed in (5, 6)]
    models = {'cpu': ('cpu', gen, disc),
              'card': ('cuda', copy.deepcopy(gen).cuda(),
                       copy.deepcopy(disc).cuda())}
    trained = [n for n in names if not n.startswith('G encoder')]
    kept = [i for i, n in enumerate(names) if n in trained]
    g_card, d_card = models['card'][1:]
    full = []
    for x, y in batches:
        every = step_grads(torch, g_card, d_card, x.cuda(), y.cuda(), s2d)[1]
        full.append([every[j] for j in kept])
    out, grads = {}, {}
    for where, (device, g, d) in models.items():
        opts = (make_optimizer(trainable_params(g, FREEZE), LR, every_k=2),
                make_optimizer(d.parameters(), LR, every_k=2))
        recorded = [([], []), ([], [])]
        for opt, (micro, applied) in zip(opts, recorded):
            record_grads(opt, micro, applied)
        step = make_train_step(g, d, *opts, s2d=s2d == 'on')
        params = list(g.parameters()) + list(d.parameters())
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        runs = []
        for x, y in batches:
            losses = step(x.to(device), y.to(device))
            runs.append(({k: v.item() for k, v in losses.items()},
                          [p.detach().cpu().clone() for p in params]))
        (g_micro, g_applied), (d_micro, d_applied) = recorded
        micro = [gm + dm for gm, dm in zip(g_micro, d_micro)]
        for name, g1, g2, mean in zip(trained, *micro,
                                      g_applied[0] + d_applied[0]):
            want = g1 + (g2 - g1) / 2
            if not (mean - want).abs().max() <= \
                    1e-6 * want.abs().max():
                raise AssertionError(f'{where}: {name}: the applied mean '
                                     f'is not the running mean')
        out[where], grads[where] = runs, micro
        print(f'  s2d {s2d}, {where}: two micro-steps in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
    launches = [w.launches for w in wrappers]
    want = [2 * n for n in FT_STEP[s2d]]
    if launches != want:
        raise AssertionError(f'fine-tune parity launches {launches}, '
                             f'expected {want}')
    for i in range(2):
        for k, want_v in out['cpu'][i][0].items():
            got = out['card'][i][0][k]
            if not abs(got - want_v) <= 2e-4 + 2e-3 * abs(want_v):
                raise AssertionError(f'micro-step {i + 1} loss {k}: card '
                                     f'{got} vs CPU {want_v}')
    for where in ('cpu', 'card'):
        first, second = out[where][0][1], out[where][1][1]
        for name, p0, p1, p2 in zip(names, start, first, second):
            if not torch.equal(p1, p0):
                raise AssertionError(f'{where}: {name} moved at the first '
                                     f'micro-step')
            if torch.equal(p2, p0) != name.startswith('G encoder'):
                raise AssertionError(f'{where}: {name} frozen: '
                                     f'{name.startswith("G encoder")}, '
                                     f'equal after the update: '
                                     f'{torch.equal(p2, p0)}')
    worst = {'loose': 0.0, 'max_diff': 0.0}
    for i in range(2):
        frozen_full = grad_errors(trained, grads['card'][i], full[i])
        card_cpu = grad_errors(trained, grads['card'][i], grads['cpu'][i])
        worst[f'micro-step {i + 1}'] = {
            'card frozen vs full': worst_error(frozen_full),
            'card vs CPU': worst_error(card_cpu)}
        print(f'  s2d {s2d}, micro-step {i + 1}, worst max |dg| / max |g|: '
              f'{worst[f"micro-step {i + 1}"]}', flush=True)
        bad = {n: e for n, e in frozen_full.items() if not e <= 1e-4}
        if i == 0:
            bad.update((f'{n} vs CPU', e) for n, e in card_cpu.items()
                       if not e <= 1e-3)
        if bad:
            raise AssertionError(f'micro-step {i + 1} gradients: {bad}')
    for name, got, want_p in zip(names, out['card'][1][1], out['cpu'][1][1]):
        if not name.startswith('G encoder'):
            loose, diff = assert_update_close(name, got, want_p)
            worst.update(loose=max(worst['loose'], loose),
                         max_diff=max(worst['max_diff'], diff))
    print(f'  s2d {s2d}: launches {launches}; losses of both micro-steps '
          f'{[r[0]["gen"] for r in out["card"]]} (card) vs '
          f'{[r[0]["gen"] for r in out["cpu"]]} (CPU); gradients of '
          f'{len(trained)} tensors as above; the applied mean the running '
          f'mean of the two; nothing moved at the first; encoder bit-equal '
          f'to its initial weights on both devices; decoder and D after '
          f'the update: loose share {worst["loose"]:.2e}, max |diff| '
          f'{worst["max_diff"]:.3e} (bound 2.5 lr)', flush=True)
    return worst


def finetune_path_phase(torch, np, wrappers, s2d, tmp, train_cfg):
    """The fine-tune of BASELINE.json config 3 through ``patchgan_train -d
    cuda`` (bf16, batch 16, 1 epoch): the training run's epoch-3 weights
    saved as torch .pth files, loaded by ``transfer_learn`` with
    ``freeze_encoder``, and ``accumulate_steps: 2``. Checks the launches
    (4 steps of ``FT_STEP``, one validation batch of ``EVAL``, 4 x 5
    recomputes), that the epoch file holds the .pth's encoder bit for
    bit and a moved decoder. Returns the launches by kernel."""
    import yaml
    from patchgan_tpu_torch.cli.train import patchgan_train
    from patchgan_tpu_torch.ops.kernels.conv_norm_act import recompute_grads
    from patchgan_tpu_torch.utils.checkpoint import load_state_dict
    pth = {}
    for net in ('generator', 'discriminator'):
        pth[net] = os.path.join(tmp, f'{net}.pth')
        torch.save(load_state_dict(os.path.join(tmp, 'ck',
                                                f'{net}_ep_003.npz')),
                   pth[net])
    with open(train_cfg) as f:
        cfg = yaml.safe_load(f)
    cfg['checkpoint_path'] = os.path.join(tmp, f'ft_{s2d}')
    cfg['load_last_checkpoint'] = False
    cfg['transfer_learn'] = {'generator_checkpoint': pth['generator'],
                             'discriminator_checkpoint': pth['discriminator'],
                             'freeze_encoder': True}
    cfg['train_params']['accumulate_steps'] = 2
    path = os.path.join(tmp, 'finetune.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    with in_dir(tmp), s2d_env(s2d):
        for w in wrappers + [recompute_grads]:
            w.launches = 0
        t0 = time.perf_counter()
        g_hist, d_hist = patchgan_train(['-c', path, '-n', '1', '-b',
                                         str(TRAIN_B), '-d', 'cuda',
                                         '--no-summary'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = [w.launches for w in wrappers]
        recomputes = recompute_grads.launches
    want = [4 * a + b for a, b in zip(FT_STEP[s2d], EVAL[s2d])]
    print(f'  s2d {s2d}: wall {wall:.2f} s, launches {launches} (expected '
          f'{want}), recomputes {recomputes} (expected '
          f'{4 * RECOMPUTES["frozen"]}), G losses {g_hist}, D losses '
          f'{d_hist}', flush=True)
    if launches != want or recomputes != 4 * RECOMPUTES['frozen']:
        raise AssertionError(f'fine-tune launches {launches}, recomputes '
                             f'{recomputes}')
    if not all(np.isfinite(g_hist + d_hist)):
        raise AssertionError(f'losses {g_hist} {d_hist}')
    before = torch.load(pth['generator'])
    after = load_state_dict(os.path.join(cfg['checkpoint_path'],
                                         'generator_ep_001.npz'))
    for k, v in before.items():
        if torch.equal(after[k], v) != k.startswith('encoder'):
            raise AssertionError(f'fine-tune: {k} equal to the .pth: '
                                 f'{torch.equal(after[k], v)}')
    print(f'  s2d {s2d}: encoder bit-equal to the .pth, decoder moved',
          flush=True)
    return launches


def eval_path_phase(torch, np, wrappers, card, tmp, train_cfg):
    """``patchgan_eval`` with the training config on its 16 validation
    images, so the newest epoch file (3) is evaluated: ``-d cuda`` (bf16)
    with the launch counts (K1 / K2 / K3 1 / 6 / 5 a batch of 8), the
    JSON line's keys, n_images 16 and values in [0, 1]; then ``-d cuda
    --dtype float32`` against ``-d cpu --dtype float32``, every metric
    within 2e-3. Then the bf16 loop's images/s on ``EVAL_TIMED`` seeded
    images in batches of 8, the first batch left out, in two runs.
    Returns (launches, the two runs' images/s, the three results)."""
    import yaml
    from patchgan_tpu_torch.cli.evaluate import patchgan_eval
    args = ['-b', '8', '--metrics', 'iou,dice,bf1']
    keys = ['metric', 'value', 'n_images', 'checkpoint', 'mean_dice',
            'mean_boundary_f1']
    with in_dir(tmp):
        for w in wrappers:
            w.launches = 0
        bf16 = patchgan_eval(['-c', train_cfg, '-d', 'cuda'] + args)
        torch.cuda.synchronize()
        launches = [w.launches for w in wrappers]
        fp32 = patchgan_eval(['-c', train_cfg, '-d', 'cuda', '--dtype',
                              'float32'] + args)
        cpu = patchgan_eval(['-c', train_cfg, '-d', 'cpu', '--dtype',
                             'float32'] + args)
    want = [2 * n for n in EVAL['off']]
    if launches != want:
        raise AssertionError(f'eval launches {launches}, expected {want}')
    for r in (bf16, fp32, cpu):
        if list(r) != keys or r['n_images'] != 16 or \
                not r['checkpoint'].endswith('generator_ep_003.npz') or \
                not all(0.0 <= r[k] <= 1.0 for k in keys[4:] + ['value']):
            raise AssertionError(f'eval result {r}')
    diffs = {k: abs(fp32[k] - cpu[k])
             for k in ('value', 'mean_dice', 'mean_boundary_f1')}
    if not all(d <= 2e-3 for d in diffs.values()):
        raise AssertionError(f'eval fp32 card vs CPU: {diffs}')
    print(f'  launches {launches}; bf16 {bf16}; fp32 card vs CPU |diff| '
          f'{diffs} (tol 2e-3)', flush=True)

    with open(train_cfg) as f:
        cfg = yaml.safe_load(f)
    t0 = time.perf_counter()
    write_npz_folder(os.path.join(tmp, 'timed'), np,
                     np.random.default_rng(9), EVAL_TIMED)
    cfg['dataset']['validation_data'] = {'images': 'timed',
                                         'masks': 'timed'}
    cfg['checkpoint_paths'] = {'generator': bf16['checkpoint']}
    timed_cfg = os.path.join(tmp, 'eval_timed.yaml')
    with open(timed_cfg, 'w') as f:
        yaml.safe_dump(cfg, f)
    print(f'  wrote {EVAL_TIMED} images in {time.perf_counter() - t0:.2f} s',
          flush=True)
    tee = Tee(sys.stdout)
    with in_dir(tmp), contextlib.redirect_stdout(tee):
        timed = [patchgan_eval(['-c', timed_cfg, '-d', 'cuda'] + args)
                 for _ in range(2)]
    if any(r['n_images'] != EVAL_TIMED for r in timed):
        raise AssertionError(f'timed eval results {timed}')
    img_s = []
    for line in tee.getvalue().splitlines():
        if ' after the first batch ' in line:
            n, secs = line.split(' after the first batch ')[1].split(
                ' images in ')
            img_s.append(int(n) / float(secs.split('s')[0]))
    print(f'  bf16 loop on {EVAL_TIMED} images, batch 8, the first batch '
          f'left out: {img_s} images/s (two runs) on {card}', flush=True)
    return launches, img_s, {'bf16': bf16, 'fp32': fp32, 'cpu': cpu}


# the throughput phase's configurations: (form, frozen, batch, every_k);
# 'off' and 'on' are the full step, the rest the fine-tune of config 3
TRAIN_CONFIGS = {'off': ('off', False, TRAIN_B, 1),
                 'on': ('on', False, TRAIN_B, 1),
                 'frozen off': ('off', True, TRAIN_B, 1),
                 'frozen on': ('on', True, TRAIN_B, 1),
                 'frozen off k=2 b=8': ('off', True, TRAIN_B // 2, 2)}


def throughput_phase(torch, np, card):
    """img/s of the bf16 train step on a device-resident batch in each of
    ``TRAIN_CONFIGS``: the full step at batch 16, plain and s2d form, the
    frozen (('enc',)) step at batch 16 in both forms, and the frozen step
    accumulating 2 micro-batches of 8 (img/s counts the images of each
    micro-step); all in turns, five windows of at least 2 s each. Peak
    memory (absolute, and above what was allocated before the
    configuration's first step), and a profiler breakdown of three steps
    of each (four micro-steps at k=2) with the device kernels launched a
    step: a frozen step must launch fewer than the full one of its
    form."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train.steps import (make_optimizer,
                                                make_train_step,
                                                trainable_params)
    bf16 = torch.bfloat16
    x, y = train_batch(torch, np, TRAIN_B, SIZE, 'cuda', 8)
    x, y = x.to(bf16), y.to(bf16)
    steps, out = {}, {}
    for name, (form, frozen, batch, every_k) in TRAIN_CONFIGS.items():
        init = torch.Generator().manual_seed(7)
        gen = UNet(IN_C, OUT_C, nf=NF, use_dropout=True, activation='relu',
                   final_act='softmax', dtype=bf16, generator=init).cuda()
        disc = Discriminator(IN_C + OUT_C, ndf=NDF, n_layers=3, dtype=bf16,
                             generator=init).cuda()
        gen.dropout_generator = torch.Generator(device='cuda').manual_seed(0)
        freeze = FREEZE if frozen else ()
        step = make_train_step(
            gen, disc, make_optimizer(trainable_params(gen, freeze), LR,
                                      mu_dtype=bf16, every_k=every_k),
            make_optimizer(disc.parameters(), LR, mu_dtype=bf16,
                           every_k=every_k),
            s2d=form == 'on')
        steps[name] = (lambda step=step, b=batch: step(x[:b], y[:b]), batch,
                       every_k)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            losses = steps[name][0]()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out[name] = {'peak_memory_bytes': peak,
                     'step_memory_bytes': peak - base,
                     'batch': batch, 'every_k': every_k,
                     'img_per_s_windows': []}
        loss = {k: float(v) for k, v in losses.items()}
        if not all(np.isfinite(list(loss.values()))):
            raise AssertionError(f'{name}: losses {loss}')
    names = list(TRAIN_CONFIGS)
    for i in range(WINDOWS):
        for name in (names if i % 2 == 0 else names[::-1]):
            fn, batch, _ = steps[name]
            count, t0 = 0, time.perf_counter()
            while True:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                count += 5
                dt = time.perf_counter() - t0
                if dt >= WINDOW_S:
                    break
            out[name]['img_per_s_windows'].append(batch * count / dt)
            print(f'  window {i} {name}: {count} steps in {dt:.3f} s, '
                  f'{batch * count / dt:.3f} img/s', flush=True)
    from torch.profiler import ProfilerActivity, profile
    for name, (fn, batch, every_k) in steps.items():
        r = out[name]
        readings = r['img_per_s_windows']
        img_s = statistics.median(readings)
        r.update(img_per_s=img_s, ms_per_step=1e3 * batch / img_s)
        print(f'  bf16 step {name}, batch {batch}, every_k {every_k}: median '
              f'{img_s:.3f} img/s (min {min(readings):.3f}, max '
              f'{max(readings):.3f}), {r["ms_per_step"]:.3f} ms/step, peak '
              f'memory {r["peak_memory_bytes"] / 2**30:.3f} GiB '
              f'({r["step_memory_bytes"] / 2**30:.3f} GiB above the '
              f'resident models) on {card}', flush=True)
        n_steps = 3 if every_k == 1 else 4
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device kernels are the entries with no CPU time of their own (an
        # operator's entry repeats its kernels' device time)
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if e.self_device_time_total > 0
                       and e.self_cpu_time_total == 0), reverse=True)
        busy = sum(row[0] for row in rows)
        ours = sum(row[0] for row in rows if 'pgt::' in row[2])
        n_kernels = sum(row[1] for row in rows) / n_steps
        print(f'  profile of {n_steps} steps, {name}: wall '
              f'{wall_us / n_steps / 1e3:.3f} ms/step, kernels '
              f'{busy / n_steps / 1e3:.3f} ms/step (device busy '
              f'{100 * busy / wall_us:.1f}%), the port\'s kernels '
              f'{ours / n_steps / 1e3:.3f} ms/step, {n_kernels:.1f} device '
              f'kernels launched a step; top kernels:', flush=True)
        for dev, n, key in rows[:15]:
            print(f'    {dev / n_steps / 1e3:8.3f} ms/step '
                  f'{n / n_steps:7.1f}/step  {key[:90]}')
        print('  the port\'s kernels:')
        for dev, n, key in rows:
            if 'pgt::' in key:
                print(f'    {dev / n_steps / 1e3:8.3f} ms/step '
                      f'{n / n_steps:7.1f}/step  {key[:90]}')
        r.update(profile_busy_ms_per_step=busy / n_steps / 1e3,
                 profile_port_kernels_ms_per_step=ours / n_steps / 1e3,
                 profile_wall_ms_per_step=wall_us / n_steps / 1e3,
                 profile_kernels_per_step=n_kernels)
    for form in ('off', 'on'):
        full, frozen = (out[form]['profile_kernels_per_step'],
                        out[f'frozen {form}']['profile_kernels_per_step'])
        print(f'  s2d {form}: device kernels a step, full {full:.1f}, frozen '
              f'{frozen:.1f}', flush=True)
        if not frozen < full:
            raise AssertionError(f's2d {form}: the frozen step launched '
                                 f'{frozen} kernels, the full {full}')
    return out


def infer_path_phase(torch, np, kernels, s2d):
    """patchgan_infer -d cuda on the four images under
    PATCHGAN_S2D=``s2d``; checks each mask and the launch counts per
    forward chunk. Returns (launches by kernel name, the model, masks)."""
    from patchgan_tpu_torch.cli.infer import patchgan_infer
    with tempfile.TemporaryDirectory() as tmp:
        cfg, sizes, model = write_inputs(tmp, torch, np)
        with in_dir(tmp):
            for k in kernels:
                k.wrapper.launches = 0
            t0 = time.perf_counter()
            with s2d_env(s2d):
                patchgan_infer(['-c', cfg, '-d', 'cuda'])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.name: k.wrapper.launches for k in kernels}
        chunks = expected_chunks(sizes)
        print(f'  s2d {s2d}: wall {wall:.2f} s, {chunks} forward chunks, '
              f'launches {launches}', flush=True)
        want = dict(zip([k.name for k in kernels],
                        [chunks, 6 * chunks, 5 * chunks, 0,
                         chunks if s2d == 'on' else 0, 0]))
        if launches != want:
            raise AssertionError(f'launches {launches}, expected {want}')
        masks = []
        for i, (h, w) in enumerate(sizes):
            mask = np.load(os.path.join(tmp, 'masks', f'{i:03d}.npy'))
            if mask.shape != (h, w) or mask.min() < 0 or \
                    mask.max() >= OUT_C:
                raise AssertionError(f'mask {i}: shape {mask.shape}, '
                                     f'labels {mask.min()}..{mask.max()}')
            print(f'  mask {i}: {mask.shape}, {len(np.unique(mask))} '
                  f'labels', flush=True)
            masks.append(mask)
    return launches, model, masks


def infer_throughput_phase(torch, np, engines, card):
    """masks/s of the 1280x960 image, one image at a time, plain and s2d
    engine in turns; tiles/s of each form's forward at buckets 8 and
    32."""
    big = np.random.default_rng(2).random((960, 1280, IN_C),
                                          dtype=np.float32)
    readings = {form: [] for form in engines}
    for eng in engines.values():
        for _ in range(3):
            eng.predict_image(big)
    for i in range(WINDOWS):
        for form in (('off', 'on') if i % 2 == 0 else ('on', 'off')):
            count, t0 = 0, time.perf_counter()
            while True:
                engines[form].predict_image(big)   # .result() waits
                count += 1
                dt = time.perf_counter() - t0
                if dt >= WINDOW_S:
                    break
            readings[form].append(count / dt)
            print(f'  1280x960 window {i} s2d {form}: {count} masks in '
                  f'{dt:.3f} s, {count / dt:.3f} masks/s', flush=True)
    out = {'card': card}
    for form, r in readings.items():
        med = statistics.median(r)
        print(f'  1280x960 s2d {form}: median {med:.3f} masks/s (min '
              f'{min(r):.3f}, max {max(r):.3f}) over {WINDOWS} windows of '
              f'>= {WINDOW_S} s on {card}')
        out[form] = {'masks_per_s_1280x960': med, 'masks_per_s_windows': r,
                     'forward_ms': {}, 'tiles_per_s': {}}
    with torch.inference_mode():
        for bs in (8, 32):
            x = torch.rand(bs, IN_C, SIZE, SIZE, device='cuda')
            for form in ('off', 'on', 'on', 'off'):
                ms = cuda_ms(lambda: engines[form]._forward(x), iters=10,
                             warmup=2)
                out[form]['forward_ms'].setdefault(bs, []).append(ms)
            for form in ('off', 'on'):
                ms = min(out[form]['forward_ms'][bs])
                out[form]['tiles_per_s'][bs] = bs / ms * 1e3
                print(f'  forward bucket {bs}, s2d {form}: '
                      f'{out[form]["forward_ms"][bs]} ms, '
                      f'{out[form]["tiles_per_s"][bs]:.1f} tiles/s on '
                      f'{card}', flush=True)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F
    from patchgan_tpu_torch.inference import InferenceEngine
    from patchgan_tpu_torch.ops.kernels import (
        _build, conv_norm_act, conv_norm_act_plain, convt_norm_act,
        convt_norm_act_plain, instance_norm_act, instance_norm_act_backward,
        instance_norm_act_backward_plain, instance_norm_act_plain,
        thin_conv3x3, thin_conv3x3_plain, thin_conv3x3_wgrad,
        thin_conv3x3_wgrad_plain)

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
               convt_norm_act, convt_norm_act_plain),
        Kernel('instance_norm_act_backward',
               'patchgan_tpu_torch/csrc/norm_act_bwd.cu',
               'patchgan_tpu/ops/pallas/norm_act.py:253',
               instance_norm_act_backward, instance_norm_act_backward_plain),
        Kernel('thin_conv3x3', 'patchgan_tpu_torch/csrc/thin_conv.cu',
               'patchgan_tpu/ops/pallas/thin_conv.py:196',
               thin_conv3x3, thin_conv3x3_plain),
        Kernel('thin_conv3x3_wgrad', 'patchgan_tpu_torch/csrc/thin_conv.cu',
               'patchgan_tpu/ops/pallas/thin_conv.py:216',
               thin_conv3x3_wgrad, thin_conv3x3_wgrad_plain))
    wrappers = [k.wrapper for k in kernels]
    print('== kernel phase (8 tiles of 256 px, nf=64; the s2d paths\' '
          'thin convs)', flush=True)
    with torch.inference_mode():
        kernel_phase(torch, F, kernels[:3])
        thin_conv_phase(torch, F, kernels[4], kernels[5])

    paths = {}
    for s2d in ('off', 'on'):
        print(f'== main path: patchgan_infer -d cuda, PATCHGAN_S2D={s2d}',
              flush=True)
        paths[f'infer_s2d_{s2d}'], model, masks = infer_path_phase(
            torch, np, kernels, s2d)
        if s2d == 'off':
            plain_masks = masks
    agree = [float(np.mean(a == b)) for a, b in zip(plain_masks, masks)]
    print(f'  s2d vs plain bf16 masks: label agreement {agree}', flush=True)

    print('== full forward, one bucket of 8 tiles', flush=True)
    tiles = torch.from_numpy(np.random.default_rng(1).random(
        (B, IN_C, SIZE, SIZE), dtype=np.float32))
    model.eval()
    engines = {}
    with torch.inference_mode():
        ref = model.to(torch.float32)(tiles)            # plain path, CPU
        for s2d in ('off', 'on'):
            with s2d_env(s2d):
                eng32 = InferenceEngine(model, dtype=torch.float32)
                engines[s2d] = InferenceEngine(model, dtype=torch.bfloat16)
            for w in wrappers:
                w.launches = 0
            p32 = eng32._forward(tiles.cuda()).cpu()
            n4 = thin_conv3x3.launches
            d32 = (p32 - ref).abs().max().item()
            del eng32
            p16 = engines[s2d]._forward(tiles.cuda()).cpu()
            d16 = (p16 - ref).abs().max().item()
            agree = (p16.argmax(1) == ref.argmax(1)).float().mean().item()
            print(f'  s2d {s2d}: fp32 kernels vs plain: max |dprob| '
                  f'{d32:.3e} (tol 1e-3), K4 launches {n4}')
            print(f'  s2d {s2d}: bf16 kernels vs fp32 plain: max |dprob| '
                  f'{d16:.3e}, argmax agreement {agree:.5f}', flush=True)
            if not d32 <= 1e-3:
                raise AssertionError(f's2d {s2d}: fp32 forward differs by '
                                     f'{d32}')
            if n4 != (1 if s2d == 'on' else 0):
                raise AssertionError(f's2d {s2d}: {n4} K4 launches')

    print('== inference throughput (bf16), plain and s2d in turns',
          flush=True)
    infer = infer_throughput_phase(torch, np, engines, card)
    print(json.dumps(infer))
    del engines

    print(f'== K1-bwd at the training shapes (batch {TRAIN_B}, 256 px, '
          f'nf={NF})', flush=True)
    backward_phase(torch, F, kernels[3])
    epoch_s, finetune = {}, {}
    names = [k.name for k in kernels]
    for s2d in ('off', 'on'):
        print('== step parity: kernel path on the card vs plain path on '
              f'the CPU (nf=64, 256 px, batch 2, fp32), s2d {s2d}',
              flush=True)
        step_parity_phase(torch, np, wrappers, s2d)
        print('== fine-tune step parity: encoder frozen, accumulate 2, '
              'kernel path on the card vs plain path on the CPU (nf=64, '
              f'256 px, two micro-batches of 2, fp32), s2d {s2d}',
              flush=True)
        finetune[f'parity_s2d_{s2d}'] = finetune_parity_phase(
            torch, np, wrappers, s2d)
        with tempfile.TemporaryDirectory() as tmp:
            print(f'== training path: patchgan_train -d cuda, then resume, '
                  f'PATCHGAN_S2D={s2d}', flush=True)
            launches, epoch_s[s2d], train_cfg = train_path_phase(
                torch, np, wrappers, card, s2d, tmp)
            paths[f'train_s2d_{s2d}'] = dict(zip(names, launches))
            print('== fine-tune path: patchgan_train -d cuda from .pth '
                  'files, freeze_encoder, accumulate_steps 2, '
                  f'PATCHGAN_S2D={s2d}', flush=True)
            paths[f'finetune_s2d_{s2d}'] = dict(zip(names, finetune_path_phase(
                torch, np, wrappers, s2d, tmp, train_cfg)))
            if s2d == 'off':
                print('== evaluation path: patchgan_eval -d cuda on the '
                      'training folder\'s validation images', flush=True)
                launches, eval_img_s, results = eval_path_phase(
                    torch, np, wrappers, card, tmp, train_cfg)
                paths['eval'] = dict(zip(names, launches))
    for s2d in ('off', 'on'):
        print(f'  s2d {s2d}, per step as counted in the runs above: the '
              f'port\'s kernels {STEP[s2d]} full, {FT_STEP[s2d]} frozen; '
              f'recomputes {RECOMPUTES["full"]} full, '
              f'{RECOMPUTES["frozen"]} frozen', flush=True)
    print(json.dumps({'eval': results, 'eval_img_per_s': eval_img_s,
                      'finetune': finetune, 'card': card}))
    print(f'== training throughput (bf16): the full step at batch {TRAIN_B} '
          'and the fine-tune step, plain and s2d, in turns', flush=True)
    train = throughput_phase(torch, np, card)
    train.update({'epoch_s': epoch_s, 'card': card})
    print(json.dumps(train))

    summary = []
    for k in kernels:
        rows = [r for r in k.rows if r.get('calls', 1)]

        def total(key):
            return sum(r.get('calls', 1) * r[key] for r in rows)
        summary.append({
            'name': k.name, 'route': 'cuda', 'source': k.source,
            'replaces': k.replaces,
            'launches': paths['train_s2d_on'][k.name],
            'launches_by_path': {p: c[k.name] for p, c in paths.items()},
            'max_abs_err': max(r['max_abs_err_bf16'] for r in k.rows),
            'ms': total('kernel_ms'), 'plain_ms': total('plain_ms'),
            'bound_ms': total('bound_ms'),
            'bound_by': max(rows, key=lambda r: r['bound_ms'])['bound_by'],
            'library_ms': total('library_ms')})
    print(json.dumps({'kernels': summary}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
