#!/usr/bin/env python3
"""Measure the inference engine's bucket table on one CUDA card.

    python3 tools/bucket_rates.py [--write] [--windows 3] [--window-s 1]

The engine picks the cheapest power-of-two chunk ("bucket") for an
image's tile count from relative generator-forward throughput by bucket
size (``patchgan_tpu_torch/inference/engine.py``, ``_pick_bucket``).
This times the bf16 nf=64 tiled forward of the engine's default form
(the plain one) at 256 px on device-resident tiles, at buckets 1, 2, 4,
8, 16, 32, 64 and 128, in turns (the order reversed every other window),
over ``--windows`` windows of at least ``--window-s`` seconds each, and
takes each bucket's median img/s. With ``--write`` it writes
``patchgan_tpu_torch/inference/bucket_rates.json`` in the JAX package's
schema (``patchgan_tpu/inference/bucket_rates.json``): the card's name
and power limit as nvidia-smi gives them, the date, the tile size, the
form, the dtype, img/s and ``rel_rate`` relative to bucket 16. Padding
tiles never reach the canvas, so the table changes no output, only the
chunking. Without a CUDA card it exits 2.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, 'patchgan_tpu_torch', 'inference',
                   'bucket_rates.json')
BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
BASE = 16   # ratios are relative to this bucket


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--size', type=int, default=256)
    ap.add_argument('--windows', type=int, default=3)
    ap.add_argument('--window-s', type=float, default=1.0)
    ap.add_argument('--write', action='store_true',
                    help='write the engine JSON in place')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('bucket_rates: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from patchgan_tpu_torch.inference import InferenceEngine
    from patchgan_tpu_torch.models import UNet
    from patchgan_tpu_torch.ops.s2d import s2d_enabled

    if s2d_enabled():
        print('bucket_rates: times the plain form; unset PATCHGAN_S2D',
              file=sys.stderr)
        return 2
    card = card_line()
    model = UNet(3, 1, nf=64, activation='relu', final_act='sigmoid',
                 generator=torch.Generator().manual_seed(0))
    eng = InferenceEngine(model, size=args.size, dtype=torch.bfloat16)
    gen = torch.Generator(device='cuda').manual_seed(0)
    tiles = torch.rand(max(BUCKETS), 3, args.size, args.size,
                       generator=gen, device='cuda')
    readings = {b: [] for b in BUCKETS}
    with torch.inference_mode():
        for b in BUCKETS:   # warm-up: kernel build, memory pools
            for _ in range(2):
                out = eng._forward(tiles[:b])
            if not torch.isfinite(out).all():
                raise AssertionError(f'bucket {b}: non-finite output')
        torch.cuda.synchronize()
        for i in range(args.windows):
            for b in (BUCKETS if i % 2 == 0 else BUCKETS[::-1]):
                x = tiles[:b]
                count, t0 = 0, time.perf_counter()
                while True:
                    eng._forward(x)
                    torch.cuda.synchronize()
                    count += 1
                    dt = time.perf_counter() - t0
                    if dt >= args.window_s:
                        break
                readings[b].append(b * count / dt)
                print(f'window {i} bucket {b:3d}: {count} forwards in '
                      f'{dt:.3f} s, {b * count / dt:.1f} img/s', flush=True)
    img_s = {b: statistics.median(r) for b, r in readings.items()}
    for b in BUCKETS:
        print(f'bucket {b:3d}: median {img_s[b]:.1f} img/s (min '
              f'{min(readings[b]):.1f}, max {max(readings[b]):.1f}) on '
              f'{card}', flush=True)
    doc = {
        'comment': 'generated by tools/bucket_rates.py; relative '
                   'generator-forward throughput by bucket size, read by '
                   'inference/engine.py _pick_bucket',
        'device': card,
        'date': time.strftime('%Y-%m-%d'),
        'size': args.size,
        's2d': False,
        'dtype': 'bfloat16',
        'img_s': {str(b): round(v, 1) for b, v in img_s.items()},
        'rel_rate': {str(b): round(v / img_s[BASE], 3)
                     for b, v in img_s.items()},
    }
    print(json.dumps(doc, indent=1))
    if args.write:
        with open(OUT, 'w') as f:
            json.dump(doc, f, indent=1)
            f.write('\n')
        print(f'wrote {os.path.relpath(OUT, ROOT)}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
