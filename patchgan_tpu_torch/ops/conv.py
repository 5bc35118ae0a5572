"""Conv / transposed-conv primitives, NCHW with torch weight layouts.

Port of ``patchgan_tpu/ops/conv.py:54-149``: torch ``Conv2d`` /
``ConvTranspose2d`` geometry at the generator's k=4, s=2, p=1, and an
optional
second input ``x2`` that is logically channel-concatenated with ``x``,
computed by linearity as two convolutions over the weight's channel
halves so the concat is never materialised. The weights are OIHW for the
conv and unflipped IOHW for the transposed conv, as torch stores them.

These serve only the generator levels that no fused kernel covers (enc0,
dec0 and the dec6 head), which the JAX package also leaves outside its
Pallas kernels.
"""

import torch.nn.functional as F


def conv2d(x, w, x2=None):
    """x: (N, C, H, W), w: (Cout, C [+ C2], 4, 4)."""
    w = w.to(x.dtype)
    if x2 is None:
        return F.conv2d(x, w, stride=2, padding=1)
    c1 = x.shape[1]
    return (F.conv2d(x, w[:, :c1], stride=2, padding=1)
            + F.conv2d(x2.to(x.dtype), w[:, c1:], stride=2, padding=1))


def conv_transpose2d(x, w, x2=None):
    """x: (N, C, H, W), w: (C [+ C2], Cout, 4, 4)."""
    w = w.to(x.dtype)
    if x2 is None:
        return F.conv_transpose2d(x, w, stride=2, padding=1)
    c1 = x.shape[1]
    return (F.conv_transpose2d(x, w[:c1], stride=2, padding=1)
            + F.conv_transpose2d(x2.to(x.dtype), w[c1:], stride=2,
                                 padding=1))
