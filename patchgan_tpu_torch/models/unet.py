"""U-Net generator (NCHW).

Port of ``patchgan_tpu/models/unet.py``: a 7-level encoder with the
filter ladder [nf, 2nf, 4nf, 8nf, 8nf, 8nf, 8nf], every encoder level
normed; a decoder mirroring it, whose first level has no norm, whose
inner levels take the skip-concatenated input (and dropout when
enabled), and whose last level maps 2nf -> output_nc with ``final_act``
in fp32. The forward collects the encoder outputs, reverses them and
skip-connects every decoder level but the first; ``return_hidden=True``
also returns the bottleneck.

``dtype`` is the compute dtype: the input is cast to it once and every
block computes in it; parameters stay as they are (fp32 from init or a
checkpoint; the inference engine pre-casts its copy once).
``dropout_generator`` is the ``torch.Generator`` the dropout masks are
drawn from in train mode (the Trainer seeds one on the model's device);
``forward(..., mesh=)`` draws them for the global batch of a
data-parallel step, and with a ``HybridMesh`` runs each level whose
weight holds a shard of its output channels on the shard and gathers
its output (``models/blocks.py``): a skip is gathered once, by its
level, and feeds both the next level and the decoder's concat.

With a ``parallel.spatial.SpatialMesh`` x is this rank's band of every
image's rows: the levels whose input rows split into bands of an even
number of rows run on bands (``models/blocks.py``); from the first that
does not (``gather_level``) the encoder, the bottom and
the decoder back up to the same rows run whole on every rank of the
spatial axis, between ``gather_band`` and ``split_band``. The output is
the band's rows.

``forward(..., s2d=True)`` (JAX ``unet.py:45-52``) runs the
space-to-depth boundary form, whose input is ``[N, 4 input_nc, H/2,
W/2]`` and output ``[N, 4 output_nc, H/2, W/2]`` (channel order (dy, dx,
c), ``ops/s2d.py``). Both forms use the same parameters and state_dict
keys, so one module serves both.
"""

import torch
import torch.nn as nn

from .blocks import DownBlock, UpBlock

N_LEVELS = 7


def gather_level(h, sp):
    """The first UNet encoder level whose input rows (``h / 2**i``) do not
    split into ``sp`` bands of an even number of rows; ``N_LEVELS`` when
    every level splits. From there the levels down to the bottom and the
    decoder back up to the same rows run whole on every rank."""
    for i in range(N_LEVELS):
        if (h >> i) % (2 * sp):
            return i
    return N_LEVELS


def unet_filters(nf):
    """Encoder filter ladder."""
    return [nf, nf * 2, nf * 4, nf * 8, nf * 8, nf * 8, nf * 8]


class UNet(nn.Module):
    def __init__(self, input_nc, output_nc, nf=64, use_dropout=False,
                 activation='tanh', final_act='softmax',
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.input_nc, self.output_nc, self.nf = input_nc, output_nc, nf
        self.dtype = dtype
        self.dropout_generator = None
        filts = unet_filters(nf)
        self.encoder = nn.ModuleList(
            DownBlock(input_nc if i == 0 else filts[i - 1], f, activation,
                      i, use_dropout=use_dropout)
            for i, f in enumerate(filts))
        dec_filts = filts[:-1][::-1]  # [8nf, 8nf, 8nf, 4nf, 2nf, nf]
        decoder = [UpBlock(filts[-1], dec_filts[0], activation, 0,
                           use_norm=False)]
        for i in range(1, len(dec_filts)):
            # previous decoder level + encoder skip rev[i] = enc(6 - i)
            decoder.append(UpBlock(dec_filts[i - 1] + filts[N_LEVELS - 1 - i],
                                   dec_filts[i], activation, i,
                                   use_dropout=use_dropout))
        decoder.append(UpBlock(dec_filts[-1] + filts[0], output_nc,
                               final_act, len(dec_filts), use_norm=False,
                               fp32_act=True))
        self.decoder = nn.ModuleList(decoder)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Xavier-uniform conv weights (the reference's weights_init)."""
        with torch.no_grad():
            for p in self.parameters():
                nn.init.xavier_uniform_(p, generator=generator)

    def forward(self, x, return_hidden=False, s2d=False, mesh=None,
                split_batch=None):
        """x: (N, input_nc, H, W) with H, W multiples of 128 -> (N,
        output_nc, H, W) float32; with ``s2d`` both in their s2d form;
        ``mesh``: x is a rank's rows of the global batch (and the model
        axis of the sharded levels);
        ``split_batch``: the K split of the fused conv kernels
        (``ops.kernels.conv_norm_act``; default N)."""
        spatial = getattr(mesh, 'spatial', None)
        h, w = x.shape[2], x.shape[3]
        if spatial is not None:
            if s2d:
                raise ValueError("a spatial mesh runs the plain form")
            h *= spatial.size   # x is a band of the image's rows
        if s2d:
            h, w = 2 * h, 2 * w   # x is the s2d form of a 2h x 2w input
        stride_total = 2 ** N_LEVELS
        if h % stride_total or w % stride_total:
            raise ValueError(
                f"UNet input spatial dims must be multiples of "
                f"{stride_total}; got {h}x{w}")
        x = x.to(self.dtype)
        if spatial is not None:
            return self._forward_bands(x, h, mesh, return_hidden,
                                       split_batch)
        gen = self.dropout_generator
        skips = []
        for i, block in enumerate(self.encoder):
            x = block(x, generator=gen, s2d_in=s2d and i == 0, mesh=mesh,
                      split_batch=split_batch)
            skips.append(x)
        hidden = skips[-1]
        rev = skips[::-1]
        x = self.decoder[0](hidden, generator=gen, mesh=mesh,
                            split_batch=split_batch)
        last = len(self.decoder) - 1
        for i in range(1, last + 1):
            x = self.decoder[i](x, skip=rev[i], generator=gen,
                                s2d_out=s2d and i == last, mesh=mesh,
                                split_batch=split_batch)
        if return_hidden:
            return x, hidden
        return x

    def _forward_bands(self, x, h, mesh, return_hidden, split_batch):
        """The forward over a spatial mesh (the module's docstring): x is
        this rank's band of rows of images ``h`` rows high."""
        axis = mesh.spatial
        level = gather_level(h, axis.size)
        gen = self.dropout_generator
        skips = []
        for i, block in enumerate(self.encoder):
            if i == level:
                x = axis.gather_band(x)
            x = block(x, generator=gen, mesh=mesh, split_batch=split_batch,
                      band=i < level)
            skips.append(x)
        hidden = skips[-1]
        rev = skips[::-1]
        x = hidden
        for i, block in enumerate(self.decoder):
            # decoder level i gives the rows of encoder level 6 - i's input
            x = block(x, skip=rev[i] if i else None, generator=gen,
                      mesh=mesh, split_batch=split_batch,
                      band=N_LEVELS - 1 - i < level)
            if N_LEVELS - 1 - i == level:
                x = axis.split_band(x)
        if return_hidden:
            return x, hidden
        return x
