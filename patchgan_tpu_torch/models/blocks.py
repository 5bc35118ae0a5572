"""Encoder / decoder building blocks (NCHW).

Port of ``patchgan_tpu/models/blocks.py:31-174``: conv(k=4, s=2, p=1,
no bias) -> instance norm (affine-free) -> activation -> optional
Dropout(0.2) in train mode, and the decoder's transposed conv with the
skip concat folded into the convolution. Each block computes in its
input's dtype (the UNet casts the image to its compute dtype once) and
casts its fp32 master weight to that dtype at use, so autograd carries
dw back to fp32 (the JAX step's ``master_grads``); the output head's
sigmoid/softmax runs in fp32. Gradients flow through the kernels'
``autograd.Function``s.

Dispatch on the card, the JAX gates run with every Pallas kernel on:
a normed DownBlock with Cin >= 16 runs kernel K2 (conv+IN+act); enc0
(Cin = 3) runs the conv and then kernel K1 (IN+act); a normed UpBlock
runs kernel K3 (convT+IN+act) at every Cout; the un-normed dec0 and the
output head run the transposed conv and the activation.

The space-to-depth boundary form (``ops/s2d.py``; JAX ``blocks.py:31-47,
106-112``): ``DownBlock(..., s2d_in=True)`` takes an s2d input and runs
its stride-2 conv as the stride-1 3x3 conv over the s2d grid (kernel K4),
then K1; ``UpBlock(..., s2d_out=True)``, the output head only, produces
its output in s2d form with the activation per parity block. Same
parameter, same per-pixel output.

Parameters sit under the reference's state_dict keys
(``model.DownConv{i}.weight`` / ``model.UpConv{i}.weight``), held by
torch conv modules that serve only as weight containers.

A step's ``mesh`` (``parallel.mesh``) has a data axis, over which the
dropout masks are drawn for the global batch, and, a ``HybridMesh``, a
model axis. A block whose weight holds a shard of its output channels
(``parallel.sharding.place_hybrid_state``) takes its whole input through
``mesh.model.enter``, computes its channels through the same dispatch
(K1-K4 run on the shard), and gathers them (``mesh.model.gather``)
after the norm and activation, which are per channel, and before the
dropout; the un-normed levels (dec0 and the output head) gather their
conv's output before the activation (the head's softmax needs every
class). A block whose output channels do not divide the model axis
computes them whole on every rank.

A ``parallel.spatial.SpatialMesh`` splits the rows over its spatial axis:
a block called with ``band=True`` holds this rank's band of them. It takes
its halo (``SpatialAxis.halo``: a row of each neighbour, of the skip too)
and runs the band form of its kernel: K2's (``conv_norm_act_band``) or,
at enc0, the conv then K1's (``instance_norm_act_band``), K3's
(``convt_norm_act_band``) for a normed UpBlock, whose statistics are
summed over the axis; the un-normed dec0 and the head run the transposed
conv over the haloed band. The dropout mask is drawn for the global shape
(every data rank's rows, every band's) and the rank keeps its own. A
block called without ``band`` on such a mesh holds its level whole
(``models/unet.py``'s ``gather_level``).

``remat=True`` (JAX ``blocks.py:47, 85-91, 120, 166-170``) runs the
block's core (the conv or transposed conv, the norm and the activation:
K1, K2, K3 or K4 and what goes with them) under
``torch.utils.checkpoint``, which keeps its inputs and recomputes the
core in the backward; only while autograd records, so a forward under
``no_grad`` or ``inference_mode`` is the same. The dropout stays outside,
so the core draws no random numbers and the checkpoint keeps no RNG
state (a CUDA generator read during a graph capture would fail). A
model axis's ``enter`` and ``gather`` stay outside too: at the
un-normed levels, whose gather comes between the conv and the
activation, the checkpoint wraps the conv alone. The band form takes no
``remat`` (the UNet refuses it).
"""

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.activations import apply_activation
from ..ops.conv import conv2d, conv_transpose2d
from ..ops.kernels import (conv_norm_act, conv_norm_act_band, convt_norm_act,
                          convt_norm_act_band, instance_norm_act_band)
from ..ops.norm import instance_norm
from ..ops.s2d import apply_activation_s2d, conv2d_s2d, conv_transpose2d_s2d

KERNEL_SIZE = 4
DROPOUT_RATE = 0.2
NORM_EPS = 1e-5
# the fused conv kernel's input-channel gate (conv_norm_act.py:94-95 in
# the JAX package): the 3-channel first level runs conv, then K1
FUSED_CONV_MIN_CIN = 16


def keep_mask(x, generator, mesh=None, band=False):
    """The dropout's keep mask for x, drawn from ``generator`` for the
    global shape: every data rank's rows with a ``mesh``, and every band's
    rows when x is a ``band`` of a spatial axis; the rank keeps its own.
    The draw is in NCHW order whatever x's layout, so a channels_last step
    draws the same mask; the comparison writes it in x's layout (one
    kernel, no copy)."""
    data = None if mesh is None else mesh.data
    spatial = mesh.spatial if band else None
    shape = list(x.shape)
    if data is not None:
        shape[0] *= data.size
    if spatial is not None:
        shape[2] *= spatial.size
    keep = torch.rand(shape, generator=generator, device=x.device)
    if data is not None:
        keep = data.local_rows(keep)
    if spatial is not None:
        keep = spatial.band(keep)
    out = torch.empty_like(x, dtype=torch.bool)
    return torch.ge(keep, DROPOUT_RATE, out=out)


def dropout(x, generator, mesh=None, band=False):
    """Flax ``nn.Dropout(0.2)`` in train mode: keep each element with
    probability 0.8 and scale it by 1/0.8, the mask drawn from
    ``generator`` (an explicit ``torch.Generator`` on x's device). With
    a ``mesh`` (``parallel.mesh``; its data axis) x is this rank's rows
    of the global batch: the mask is drawn for the global batch and the
    rank keeps its rows, as JAX draws it over a sharded batch, so a
    sample's mask depends on the seed and its global row only and every
    rank's generator advances alike. Every rank of a model group draws
    the same mask; a ``band`` of a spatial axis keeps its rows of the
    whole image's mask (``keep_mask``)."""
    keep = keep_mask(x, generator, mesh, band)
    return torch.where(keep, x / (1.0 - DROPOUT_RATE), 0.0).to(x.dtype)


def run_core(core, remat, *args):
    """``core(*args)``; under a checkpoint (recomputed in the backward)
    when ``remat`` and autograd records."""
    if remat and torch.is_grad_enabled():
        return checkpoint(core, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return core(*args)


def sharded_axis(mesh, conv):
    """``mesh``'s model axis when ``conv`` (a Conv2d or ConvTranspose2d)
    holds a shard of its output channels, else None."""
    if mesh is None or mesh.model is None:
        return None
    dim = 1 if isinstance(conv, nn.ConvTranspose2d) else 0
    return mesh.model if conv.weight.shape[dim] != conv.out_channels \
        else None


class DownBlock(nn.Module):
    """Strided conv -> instance norm -> activation -> optional dropout."""

    def __init__(self, in_channels, features, activation, level,
                 use_dropout=False, use_norm=True, remat=False):
        super().__init__()
        self.activation = activation
        self.use_norm = use_norm
        self.remat = remat
        self.name = f'DownConv{level}'
        self.model = nn.ModuleDict({self.name: nn.Conv2d(
            in_channels, features, KERNEL_SIZE, 2, 1, bias=False)})
        self.use_dropout = use_dropout

    @property
    def weight(self):
        return self.model[self.name].weight

    def forward(self, x, generator=None, s2d_in=False, mesh=None,
                split_batch=None, band=False):
        """``s2d_in``: x is the s2d form [N, 4C, H/2, W/2] of the input;
        ``mesh``: x is a rank's rows, for the dropout draw, and the model
        axis of a sharded weight; ``split_batch``: the fused kernel's K
        split (``conv_norm_act``); ``band``: x is this rank's band of the
        rows over ``mesh.spatial``."""
        if band:
            return self._band_forward(x, generator, mesh, split_batch)
        model = sharded_axis(mesh, self.model[self.name])
        if model is not None:
            x = model.enter(x)
        w = self.weight.to(x.dtype)
        x = run_core(self._core, self.remat, x, w, s2d_in, split_batch)
        if model is not None:
            x = model.gather(x)
        if self.use_dropout and self.training:
            x = dropout(x, generator, mesh)
        return x

    def _core(self, x, w, s2d_in, split_batch):
        """conv -> norm -> activation."""
        if s2d_in:
            x = conv2d_s2d(x, w)
            return instance_norm(x, NORM_EPS, self.activation) \
                if self.use_norm else apply_activation(x, self.activation)
        if self.use_norm and x.shape[1] >= FUSED_CONV_MIN_CIN:
            return conv_norm_act(x, w, NORM_EPS, self.activation,
                                 split_batch)
        if self.use_norm:
            return instance_norm(conv2d(x, w), NORM_EPS, self.activation)
        return apply_activation(conv2d(x, w), self.activation)

    def _band_forward(self, x, generator, mesh, split_batch):
        axis = mesh.spatial
        w = self.weight.to(x.dtype)
        xh = axis.halo(x, 1, 1)
        # the output plane's global elements: every band's rows
        count = x.shape[2] // 2 * axis.size * (x.shape[3] // 2)
        if self.use_norm and x.shape[1] >= FUSED_CONV_MIN_CIN:
            x = conv_norm_act_band(xh, w, NORM_EPS, self.activation, axis,
                                   count, split_batch)
        elif self.use_norm:
            x = instance_norm_act_band(conv2d(xh, w, padding=(0, 1)),
                                       NORM_EPS, self.activation, axis,
                                       count)
        else:
            x = apply_activation(conv2d(xh, w, padding=(0, 1)),
                                 self.activation)
        if self.use_dropout and self.training:
            x = dropout(x, generator, mesh, band=True)
        return x


class UpBlock(nn.Module):
    """Transposed conv over concat(x, skip) -> optional instance norm ->
    activation -> optional dropout. ``fp32_act``: the output head, whose
    activation runs in fp32 (bf16 saturates sigmoid/softmax to exact 0/1
    at |logit| ~ 9)."""

    def __init__(self, in_channels, features, activation, level,
                 use_norm=True, use_dropout=False, fp32_act=False,
                 remat=False):
        super().__init__()
        self.activation = activation
        self.use_norm = use_norm
        self.fp32_act = fp32_act
        self.remat = remat
        self.name = f'UpConv{level}'
        self.model = nn.ModuleDict({self.name: nn.ConvTranspose2d(
            in_channels, features, KERNEL_SIZE, 2, 1, bias=False)})
        self.use_dropout = use_dropout

    @property
    def weight(self):
        return self.model[self.name].weight

    def forward(self, x, skip=None, generator=None, s2d_out=False,
                mesh=None, split_batch=None, band=False):
        """``s2d_out``: produce the s2d form [N, 4 Cout, H, W] of the
        output (the output head only); ``mesh``, ``split_batch`` and
        ``band`` as in DownBlock (the skip is a band too)."""
        w = self.weight.to(x.dtype)
        skip = skip.to(x.dtype) if skip is not None else None
        if band:
            return self._band_forward(x, skip, w, generator, mesh,
                                      split_batch)
        if s2d_out and self.use_norm:
            raise ValueError("s2d_out is an output-head option "
                             "(use_norm=False)")
        model = sharded_axis(mesh, self.model[self.name])
        if model is not None:
            x = model.enter(x)
            skip = model.enter(skip) if skip is not None else None
        if model is not None and not self.use_norm:
            # the activation (the head's softmax) needs every channel:
            # the gather comes between the conv and the activation; the
            # s2d channels are (dy, dx, class), four blocks
            out = run_core(self._conv, self.remat, x, w, skip, s2d_out)
            x = self._act(model.gather(out, blocks=4 if s2d_out else 1),
                          s2d_out)
        else:
            x = run_core(self._core, self.remat, x, w, skip, s2d_out,
                         split_batch)
            if model is not None:
                x = model.gather(x)
        if self.use_dropout and self.training:
            x = dropout(x, generator, mesh)
        return x

    def _conv(self, x, w, skip, s2d_out):
        conv = conv_transpose2d_s2d if s2d_out else conv_transpose2d
        return conv(x, w, x2=skip)

    def _act(self, out, s2d_out):
        """The activation, per parity block of an s2d output; in fp32
        for the output head."""
        if self.fp32_act:
            out = out.float()
        act = apply_activation_s2d if s2d_out else apply_activation
        return act(out, self.activation)

    def _core(self, x, w, skip, s2d_out, split_batch):
        """transposed conv -> norm -> activation."""
        if self.use_norm:
            return convt_norm_act(x, w, NORM_EPS, self.activation, skip,
                                  split_batch)
        return self._act(self._conv(x, w, skip, s2d_out), s2d_out)

    def _band_forward(self, x, skip, w, generator, mesh, split_batch):
        axis = mesh.spatial
        xh = axis.halo(x, 1, 1)
        skh = axis.halo(skip, 1, 1) if skip is not None else None
        if self.use_norm:
            count = 2 * x.shape[2] * axis.size * 2 * x.shape[3]
            x = convt_norm_act_band(xh, w, NORM_EPS, self.activation, axis,
                                    count, skh, split_batch)
        else:
            out = conv_transpose2d(xh, w, x2=skh, padding=(3, 1))
            if self.fp32_act:
                out = out.float()
            x = apply_activation(out, self.activation)
        if self.use_dropout and self.training:
            x = dropout(x, generator, mesh, band=True)
        return x
