"""Patch-wise (pix2pix-style) discriminator (NCHW).

Port of ``patchgan_tpu/models/disc.py:43-160``:

- the input is the channel concat of image and mask (a plain
  ``torch.cat``);
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
"""

import math

import torch
import torch.nn as nn

from ..ops.activations import apply_activation
from ..ops.conv import conv2d
from ..ops.norm import instance_norm
from .blocks import KERNEL_SIZE, NORM_EPS


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

    def forward(self, x, y=None):
        """x: (N, Ci, H, W) image, y: optional (N, Cm, H, W) mask
        concatenated to it. Returns fp32 probabilities (N, 1, H', W')."""
        h = x.to(self.dtype)
        if y is not None:
            h = torch.cat([h, y.to(self.dtype)], dim=1)
        for idx, stride, act, normed in self.plan:
            conv = self.model[idx]
            h = conv2d(h, conv.weight, stride=stride, padding=1,
                       bias=conv.bias)
            if act == 'sigmoid':
                # fp32 head: bf16 saturates to exact 0/1 at |logit| ~ 9
                return apply_activation(h.float(), act)
            h = apply_activation(h, act)
            if normed:
                h = instance_norm(h, NORM_EPS)
        return h
