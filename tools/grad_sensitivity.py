#!/usr/bin/env python3
"""How far a relative perturbation of the input far below any test's
tolerance moves the G+D step's gradients, on the CPU's plain path.

    python3 tools/grad_sensitivity.py [--seed 5] [--trials 6] [--scale 1e-6]
                                      [--activation relu]

Builds the models and the batch of ``chip_smoke.py``'s parity phases
(nf=64, 256 px, batch 2, fp32, init seed 4, batch ``--seed``), takes
the generator's and the discriminator's gradients once as they are and
then ``--trials`` times with x multiplied by 1 + scale * N(0, 1), and
prints for each trial and each generator tensor max |dg| / max |g|
against the unperturbed gradients. Where that share reaches 1e-2 or more
at a scale of 1e-6, the gradient is not continuous at rounding scale
there (a ReLU input within rounding of 0 at a level whose plane holds a
few elements: ``--activation tanh`` shows the smooth case), and a
card-vs-CPU limit on it measures on which side each device rounds, not
the kernels.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--seed', type=int, default=5)
    parser.add_argument('--trials', type=int, default=6)
    parser.add_argument('--scale', type=float, default=1e-6)
    parser.add_argument('--activation', default='relu')
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import chip_smoke as cs
    from patchgan_tpu_torch.models import Discriminator, UNet
    init = torch.Generator().manual_seed(4)
    gen = UNet(cs.IN_C, cs.OUT_C, nf=cs.NF, activation=args.activation,
               final_act='softmax', generator=init)
    disc = Discriminator(cs.IN_C + cs.OUT_C, ndf=cs.NDF, n_layers=3,
                         generator=init)
    names = [n.split('.model.')[1].split('.')[0]
             for n, _ in gen.named_parameters()]
    x, y = cs.train_batch(torch, np, 2, cs.SIZE, 'cpu', args.seed)
    base = cs.step_grads(torch, gen, disc, x, y, 'off')[1]
    rng = np.random.default_rng(0)
    print(f'{args.activation}, batch seed {args.seed}, x * (1 + '
          f'{args.scale:g} N(0, 1)): max |dg| / max |g| per generator '
          'tensor')
    for t in range(args.trials):
        noise = rng.standard_normal(x.shape).astype(np.float32)
        xp = x * (1 + args.scale * torch.from_numpy(noise))
        grads = cs.step_grads(torch, gen, disc, xp, y, 'off')[1]
        print(f'trial {t}: ' + ' '.join(
            f'{n} {((g - b).abs().max() / b.abs().max()).item():.1e}'
            for n, g, b in zip(names, grads, base)))


if __name__ == '__main__':
    main()
