"""Patch-wise (pix2pix-style) discriminator (NCHW).

Port of ``patchgan_tpu/models/disc.py:43-160``:

- the input is the channel concat of image and mask (a plain
  ``torch.cat``), or, in the paired and s2d forms below, conv0 split by
  linearity into an image part and a mask part;
- conv0: Conv(k=4, s=2, p=1, bias) + LeakyReLU(0.2);
- layers 1..n_layers-1: Conv(k=4, s=2, p=1, no bias) + **Tanh**, then
  instance norm AFTER the activation when ``norm=True``;
- one stride-1 Conv(no bias) + Tanh (+ norm);
- conv_out: stride-1 Conv -> 1 channel (bias), sigmoid in fp32;
- filters ndf * min(2^n, 8).

Every conv computes in the compute dtype ``dtype`` (input and weights
cast at use, parameters fp32). Weights are xavier-uniform, biases
uniform(+-1/sqrt(fan_in)), both from an explicit generator. Parameters
sit under the reference's Sequential keys ``model.{idx}.weight`` /
``model.{idx}.bias`` (``utils/transfer.py:74-99``); the activation and
norm entries of ``model`` hold no parameters and only keep the indices.

Two forms of conv0 (JAX ``disc.py:50-131``):

- paired: ``y`` a tuple of masks sharing one image (the train step's
  real and fake pair) gives one output per mask, with conv0's image part
  computed once, so its weight gradient is one contraction of the summed
  gradients;
- ``forward(..., s2d=True)``: x and y arrive in space-to-depth form and
  conv0 runs ``conv2d_s2d``, the stride-1 3x3 equivalent over the s2d
  grid (kernel K4 on the card), with the same parameters. The layers
  after conv0 are unchanged.

``forward(..., mesh=HybridMesh)`` runs each conv whose weight holds a
shard of its output channels (``parallel.sharding``) as the blocks do
(``models/blocks.py``): its whole input through ``mesh.model.enter``, its
channels (and its bias's) with the activation and the norm, which are
per channel, then ``mesh.model.gather``. conv0's image and mask parts
each enter; ``conv_out`` (one channel) is replicated and computed whole
on every rank.

``forward(..., mesh=SpatialMesh)`` takes this rank's band of the image's
rows (``parallel/spatial.py``): conv0 and the stride-2 layers take a
halo row above and below (conv0's image part still computed once in the
paired form); the stride-1 layers, whose output has ``H - 1`` rows, take
one row above and two below, and the rank keeps output rows ``[a, b) &
[0, H - 1)`` of its input band ``[a, b)``; ``norm=True`` takes K1's band
form. The output is the rank's rows (``disc_rows``).
Where the bands do not fit that rule (``disc_splits``), the image and
masks are gathered, the discriminator runs whole, and the rank keeps an
even share of the output rows.
"""

import math

import torch
import torch.nn as nn

from ..ops.activations import apply_activation
from ..ops.conv import conv2d
from ..ops.kernels import instance_norm_act_band
from ..ops.norm import instance_norm
from ..ops.s2d import conv2d_s2d
from .blocks import KERNEL_SIZE, NORM_EPS, sharded_axis


def disc_splits(h, sp, n_layers):
    """Whether the discriminator runs on bands: every stride-2 layer's input
    band has an even number of rows, and the stride-1 layers' input bands
    at least 3 (each loses up to one row at the bottom, and lends two to a
    halo). Otherwise it runs whole on every rank."""
    for k in range(n_layers):
        if (h >> k) % (2 * sp):
            return False
    return (h >> n_layers) % sp == 0 and (h >> n_layers) // sp >= 3


def disc_rows(h, sp, rank, n_layers):
    """(lo, hi, rows) of the discriminator's output that ``rank`` owns at
    input height ``h``: the band rule (``[a, b) & [0, H_out)`` at each
    stride-1 layer) where ``disc_splits``, else an even share."""
    out = (h >> n_layers) - 2
    if disc_splits(h, sp, n_layers):
        n = (h >> n_layers) // sp
        return rank * n, min((rank + 1) * n, out), out
    return rank * out // sp, (rank + 1) * out // sp, out


class Discriminator(nn.Module):
    def __init__(self, input_nc, ndf=64, n_layers=3, norm=False,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.input_nc, self.ndf = input_nc, ndf
        self.n_layers, self.norm, self.dtype = n_layers, norm, dtype
        layers = []
        # (Sequential index of the conv, stride, activation, norm after)
        self.plan = []

        def add(cin, cout, stride, bias, act, act_module, normed):
            self.plan.append((len(layers), stride, act, normed))
            layers.append(nn.Conv2d(cin, cout, KERNEL_SIZE, stride, 1,
                                    bias=bias))
            if act_module is not None:
                layers.append(act_module)
            if normed:
                layers.append(nn.InstanceNorm2d(cout))

        add(input_nc, ndf, 2, True, 'leakyrelu', nn.LeakyReLU(0.2), False)
        nf_mult = 1
        for n in range(1, n_layers):
            prev, nf_mult = nf_mult, min(2 ** n, 8)
            add(ndf * prev, ndf * nf_mult, 2, False, 'tanh', nn.Tanh(),
                norm)
        prev, nf_mult = nf_mult, min(2 ** n_layers, 8)
        add(ndf * prev, ndf * nf_mult, 1, False, 'tanh', nn.Tanh(), norm)
        add(ndf * nf_mult, 1, 1, True, 'sigmoid', None, False)
        self.model = nn.Sequential(*layers)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Xavier-uniform weights; biases uniform(+-1/sqrt(fan_in)), the
        torch Conv2d default the reference's weights_init leaves alone."""
        with torch.no_grad():
            for idx, *_ in self.plan:
                conv = self.model[idx]
                nn.init.xavier_uniform_(conv.weight, generator=generator)
                if conv.bias is not None:
                    bound = 1.0 / math.sqrt(conv.weight[0].numel())
                    conv.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x, y=None, s2d=False, mesh=None):
        """x: (N, Ci, H, W) image; y: optional (N, Cm, H, W) mask
        concatenated to it, or a tuple of such masks (the paired form).
        With ``s2d`` x and y are in s2d form; ``mesh``: the model axis of
        the sharded convs (the module's docstring).
        Returns fp32 probabilities (N, 1, H', W'), a tuple of them when y
        is a tuple."""
        paired = isinstance(y, (tuple, list))
        x = x.to(self.dtype)
        if paired:
            y = tuple(m.to(self.dtype) for m in y)
            if any(m.shape != y[0].shape for m in y):
                raise ValueError("paired masks must share one shape")
        elif y is not None:
            y = y.to(self.dtype)
        if getattr(mesh, 'spatial', None) is not None:
            if s2d:
                raise ValueError("a spatial mesh runs the plain form")
            outs = self._forward_bands(x, y if paired else (y,), mesh.spatial)
            return outs if paired else outs[0]
        conv0 = self.model[self.plan[0][0]]
        model = sharded_axis(mesh, conv0)
        if model is not None:
            # entered in the compute dtype: their gradients sum in it
            x = model.enter(x)
            if paired:
                y = tuple(model.enter(m) for m in y)
            elif y is not None:
                y = model.enter(y)
        w0 = conv0.weight.to(self.dtype)
        if paired:
            hs = conv2d_s2d(x, w0, bias=conv0.bias, x2s=y) if s2d else \
                conv2d(x, w0, stride=2, padding=1, bias=conv0.bias, x2s=y)
        elif s2d:
            hs = (conv2d_s2d(x, w0, bias=conv0.bias, x2=y),)
        else:
            h = x if y is None else torch.cat([x, y], dim=1)
            hs = (conv2d(h, w0, stride=2, padding=1, bias=conv0.bias),)
        outs = tuple(self._tail(h, model, mesh) for h in hs)
        return outs if paired else outs[0]

    def _tail(self, h, model0, mesh):
        """conv0's activation (and gather, over ``model0``) and the layers
        after it."""
        h = apply_activation(h, self.plan[0][2])
        if model0 is not None:
            h = model0.gather(h)
        for idx, stride, act, normed in self.plan[1:]:
            conv = self.model[idx]
            model = sharded_axis(mesh, conv)
            if model is not None:
                h = model.enter(h)
            h = conv2d(h, conv.weight, stride=stride, padding=1,
                       bias=conv.bias)
            if act == 'sigmoid':
                if model is not None:
                    h = model.gather(h)
                # fp32 head: bf16 saturates to exact 0/1 at |logit| ~ 9
                return apply_activation(h.float(), act)
            h = apply_activation(h, act)
            if normed:
                h = instance_norm(h, NORM_EPS)
            if model is not None:
                h = model.gather(h)
        return h

    def _forward_bands(self, x, ys, axis):
        """The outputs for the masks ``ys`` (None: the image alone) over the
        spatial ``axis``, x and ys this rank's bands (the module's
        docstring)."""
        h = x.shape[2] * axis.size
        lo, hi, _ = disc_rows(h, axis.size, axis.rank, self.n_layers)
        if not disc_splits(h, axis.size, self.n_layers):
            xw = axis.gather_band(x)
            if ys == (None,):
                outs = (self.forward(xw),)
            else:
                outs = self.forward(xw, tuple(axis.gather_band(m)
                                              for m in ys))
            return tuple(axis.split_rows(o, lo, hi) for o in outs)
        conv0 = self.model[self.plan[0][0]]
        w0 = conv0.weight.to(self.dtype)
        xh = axis.halo(x, 1, 1)
        if ys == (None,):
            hs = (conv2d(xh, w0, padding=(0, 1), bias=conv0.bias),)
        else:
            hs = conv2d(xh, w0, padding=(0, 1), bias=conv0.bias,
                        x2s=tuple(axis.halo(m, 1, 1) for m in ys))
        return tuple(self._tail_bands(t, axis, h // 2) for t in hs)

    def _tail_bands(self, t, axis, rows):
        """conv0's activation and the layers after it on a band; ``rows``
        is the global height of conv0's output."""
        t = apply_activation(t, self.plan[0][2])
        lo = axis.rank * (rows // axis.size)
        hi = lo + t.shape[2]
        for idx, stride, act, normed in self.plan[1:]:
            conv = self.model[idx]
            if stride == 2:
                t = conv2d(axis.halo(t, 1, 1), conv.weight, stride=2,
                           padding=(0, 1), bias=conv.bias)
                lo, hi, rows = lo // 2, hi // 2, rows // 2
            else:
                # output rows H - 1: keep [lo, hi) & [0, rows - 1)
                t = conv2d(axis.halo(t, 1, 2), conv.weight, stride=1,
                           padding=(0, 1), bias=conv.bias)
                rows -= 1
                hi = min(hi, rows)
                t = t[:, :, :hi - lo]
            if act == 'sigmoid':
                return apply_activation(t.float(), act)
            t = apply_activation(t, act)
            if normed:
                t = instance_norm_act_band(t, NORM_EPS, None, axis,
                                           rows * t.shape[3])
        return t
