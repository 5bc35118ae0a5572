#!/usr/bin/env python3
"""How far two gloo ranks' data-parallel steps sit from one process's on
the card, against what rounding alone moves (one H100, fp32, TF32 off).

    python3 tools/dp_rounding.py [--activation relu|tanh]

Config 2's widths (nf=64, ndf=64, 256 px, 7 classes, softmax head,
dropout on), three steps of the loader's global batch of 16 with flips,
Adam at 1e-3, deterministic cuDNN: ``chip_smoke.py``'s phase 14b run
(``dp_gloo_run``) with the activation asked for. Three runs from the
same seeds:

- two gloo ranks sharing card 0, 8 rows each (``DataMesh``);
- one process on the whole batch;
- one process on the whole batch with cuDNN's benchmark algorithms in
  place of its deterministic heuristics: a rounding-only control.

Prints, for the ranks and for the control against the one process: the
weights outside ``tests/test_distributed.py``'s limits (rtol 5e-3 /
atol 2e-4) after the steps, the last step's losses, and per tensor the
first update's gradients (max |diff| over max |g|, the share of
elements whose sign differs). Then the generator's forward on the batch
at 16 rows and on its two halves of 8 apart (fp32, eval mode): the
kernels' K split depends on the batch (``pgt_conv_splits``), so a
sample's activations round differently at 8 and 16 rows.
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def run(mesh, activation):
    """(each step's losses, G's and D's first-update gradients, the
    weights after the steps, the generator): ``chip_smoke``'s 14b run."""
    losses, _, gen, disc, grads = cs.dp_gloo_run(torch, np, mesh,
                                                 activation)
    weights = [p.detach().cpu() for m in (gen, disc)
               for p in m.parameters()]
    return losses, grads, weights, gen


def flags(deterministic=True):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = not deterministic


def rank():
    """A rank: ``tools/dp_rounding.py --rank R PORT OUT ACTIVATION``."""
    r, port, out, act = sys.argv[2:6]
    torch.cuda.set_device(0)
    flags()
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            rank=int(r), world_size=2)
    from patchgan_tpu_torch.parallel import DataMesh
    losses, grads, weights, _ = run(DataMesh('cuda:0'), act)
    if r == '0':
        torch.save((losses, grads, weights), os.path.join(out, 'dp.pt'))
    dist.destroy_process_group()


def loose(a, b):
    n, mx = 0, 0.0
    for x, y in zip(a, b):
        d = (x - y).abs()
        n += int((d > 2e-4 + 5e-3 * y.abs()).sum())
        mx = max(mx, float(d.max()))
    return n, sum(y.numel() for y in b), mx


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--activation', default='relu',
                        choices=['relu', 'tanh'])
    args = parser.parse_args()
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.ops.kernels import _build
    _build.build()
    print(cs.card_line(), f'activation {args.activation}, {cs.DP_STEPS} '
          f'steps', flush=True)
    env = dict(os.environ, PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        port = cs.free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--rank', str(r),
             str(port), tmp, args.activation], env=env)
            for r in range(2)]
        rcs = [p.wait(timeout=900) for p in procs]
        if any(rcs):
            raise SystemExit(f'ranks exited {rcs}')
        dp = torch.load(os.path.join(tmp, 'dp.pt'), weights_only=True)
    runs = {}
    for name, det in (('one process', True), ('control', False)):
        flags(det)
        runs[name] = run(None, args.activation)
    flags()
    one = runs['one process']
    names = [n for m in (UNet(3, 7, nf=4), Discriminator(10, ndf=4))
             for n, _ in m.named_parameters()]
    for label, other in (('two gloo ranks', dp),
                         ('control (cuDNN benchmark)', runs['control'])):
        n, total, mx = loose(other[2], one[2])
        print(f'{label} vs one process: weights outside rtol 5e-3 / atol '
              f'2e-4 after {cs.DP_STEPS} steps: {n} of {total} (max |diff| '
              f'{mx:.3e}); last losses {other[0][-1]}', flush=True)
        print('  first update, per tensor: max |diff| / max |g|, sign '
              'differs')
        for nm, a, b in zip(names, other[1][0] + other[1][1],
                            one[1][0] + one[1][1]):
            d = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            s = float(((a > 0) != (b > 0)).float().mean())
            print(f'    {nm:36s} {d:.3e} {s:.5f}')
    print(f'one process: last losses {one[0][-1]}')
    gen = one[3].eval()
    x = torch.rand((cs.TRAIN_B, cs.IN_C, cs.SIZE, cs.SIZE), device='cuda',
                   generator=torch.Generator(device='cuda').manual_seed(3))
    with torch.no_grad():
        whole = gen(x)
        halves = torch.cat([gen(x[:8]), gen(x[8:])])
    print(f'generator forward, 16 rows against two halves of 8: max |dprob| '
          f'{float((whole - halves).abs().max()):.3e}, equal bits '
          f'{torch.equal(whole, halves)}')


if __name__ == '__main__':
    if sys.argv[1:2] == ['--rank']:
        rank()
    else:
        main()
