#!/usr/bin/env python3
"""Time the tiled forward at each K split of the fused conv kernels on
one CUDA card, and check that a fixed split makes a tile's output the
same bits in any batch.

    python3 tools/split_batch.py [--splits 1,4,8,32] [--windows 2]

K2 and K3 split their K loop by the batch they run (in bf16 the wgmma
core's plan, ``nhwc_gemm_plan``; on the WMMA core ``choose_splits``):
fewer samples, more splits. So a tile's sums run in another order in a
bucket of 32 than in a share of 8, and in bf16 the masks differ on a
fraction of a percent of pixels. ``split_batch=S`` fixes the split (and
the wgmma core's tile and ring depth, which change no sum) to a batch of
S samples. This runs the bf16 nf=64 3 -> 7
generator (seeded random weights, 256-px seeded noise tiles): first the
outputs of a bucket of 32 against four shares of 8 and against the first
32 rows of a bucket of 128, with each batch's own split and with each
fixed one (max |diff|); then the forward ms (CUDA events over 10 calls
after 3) at buckets 8 to 128, each split in turns, ``--windows`` times
with the order reversed every other time. The engine's choice is
``inference/engine.py``'s ``SPLIT_BATCH``. Without a CUDA card it exits
2.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (8, 16, 32, 64, 128)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--splits', default='1,4,8,32',
                        help='fixed split batches to time beside each '
                             "batch's own")
    parser.add_argument('--windows', default=2, type=int)
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('split_batch: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from patchgan_tpu_torch.models import UNet
    from patchgan_tpu_torch.ops.kernels import _build
    _build.build()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    splits = [None] + [int(s) for s in args.splits.split(',')]
    model = UNet(3, 7, nf=64, activation='relu', final_act='softmax',
                 dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(0))
    model = model.to('cuda', torch.bfloat16).eval()
    x = torch.from_numpy(np.random.default_rng(1).random(
        (max(BUCKETS), 3, 256, 256), dtype=np.float32)).cuda()

    def ms(b, split):
        for _ in range(3):
            model(x[:b], split_batch=split)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            model(x[:b], split_batch=split)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 10

    with torch.inference_mode():
        for split in splits:
            full = model(x[:32], split_batch=split)
            shares = torch.cat([model(x[i:i + 8], split_batch=split)
                                for i in range(0, 32, 8)])
            big = model(x, split_batch=split)[:32]
            print(f'split_batch {split}: bucket 32 against 4 shares of 8 '
                  f'max |diff| {(full - shares).abs().max().item():.3e}, '
                  f'against rows 0-31 of bucket 128 '
                  f'{(full - big).abs().max().item():.3e}', flush=True)
        for b in BUCKETS:
            times = {split: [] for split in splits}
            for w in range(args.windows):
                for split in (splits if w % 2 == 0 else splits[::-1]):
                    times[split].append(ms(b, split))
            print(f'bucket {b}: forward ms by split_batch '
                  f'{ {str(s): [round(t, 3) for t in v] for s, v in times.items()} }'
                  f' on {card}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
