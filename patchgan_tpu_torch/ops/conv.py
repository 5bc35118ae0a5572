"""Conv / transposed-conv primitives, NCHW with torch weight layouts.

Port of ``patchgan_tpu/ops/conv.py:54-149``: torch ``Conv2d`` /
``ConvTranspose2d`` geometry (k=4; s=2, p=1 by default), an optional
bias, and an optional second input ``x2`` that is logically
channel-concatenated with ``x``, computed by linearity as two
convolutions over the weight's channel halves so the concat is never
materialised. The weights are OIHW for the conv and unflipped IOHW for
the transposed conv, as torch stores them; weight and bias are cast to
x's dtype at use.

These serve the generator levels that no fused kernel covers (enc0,
dec0 and the dec6 head), which the JAX package also leaves outside its
Pallas kernels, and the discriminator. The weight's channel halves are
taken with ``split``, whose backward concatenates their gradients and so
keeps a channels_last weight's gradient channels_last (a slice's backward
writes into a new NCHW tensor); the values are the same.
"""

import torch.nn.functional as F


def conv2d(x, w, x2=None, stride=2, padding=1, bias=None, x2s=None):
    """x: (N, C, H, W), w: (Cout, C [+ C2], k, k), bias: (Cout,);
    ``padding`` an int or torch's (rows, columns) pair (``(0, 1)`` over a
    haloed band, ``parallel/spatial.py``).

    ``x2s``, a tuple of second inputs of one shape, returns one output
    per element, each equal to ``conv2d(x, w, x2=m)``, with the x-part
    conv computed once and shared: its weight gradient then contracts
    the sum of the outputs' gradients once (the paired discriminator,
    models/disc.py)."""
    w = w.to(x.dtype)
    b = bias.to(x.dtype) if bias is not None else None
    if x2s is not None:
        if x2 is not None:
            raise ValueError("conv2d: pass x2 or x2s, not both")
        w1, w2 = _halves(w, x, 1)
        shared = F.conv2d(x, w1, b, stride=stride, padding=padding)
        return tuple(shared + F.conv2d(m.to(x.dtype), w2, stride=stride,
                                       padding=padding)
                     for m in x2s)
    if x2 is None:
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    w1, w2 = _halves(w, x, 1)
    return (F.conv2d(x, w1, b, stride=stride, padding=padding)
            + F.conv2d(x2.to(x.dtype), w2, stride=stride, padding=padding))


def _halves(w, x, dim):
    """w's input-channel halves along ``dim``: x's channels, the rest."""
    c1 = x.shape[1]
    return w.split([c1, w.shape[dim] - c1], dim=dim)


def conv_transpose2d(x, w, x2=None, padding=1):
    """x: (N, C, H, W), w: (C [+ C2], Cout, 4, 4); ``padding`` as torch's
    (``(3, 1)`` gives a haloed band's own rows, ``parallel/spatial.py``)."""
    w = w.to(x.dtype)
    if x2 is None:
        return F.conv_transpose2d(x, w, stride=2, padding=padding)
    w1, w2 = _halves(w, x, 0)
    return (F.conv_transpose2d(x, w1, stride=2, padding=padding)
            + F.conv_transpose2d(x2.to(x.dtype), w2, stride=2,
                                 padding=padding))
