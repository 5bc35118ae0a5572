"""Space-to-depth (s2d) boundary form of the stride-2 boundary convolutions,
NCHW with torch weight layouts.

Port of ``patchgan_tpu/ops/s2d.py``. The full-resolution few-channel
tensors (the generator's input and output, the discriminator's image and
mask) enter and leave a step in their s2d form ``[N, 4C, H/2, W/2]``,
channel order ``(dy, dx, c)`` as in the JAX package, so an s2d tensor of
the port equals the JAX one after an NHWC -> NCHW transpose:

- every stride-2 boundary conv (generator enc0, discriminator conv0)
  becomes a stride-1 3x3 conv over the s2d grid with a rearranged,
  zero-padded kernel, numerically the same conv;
- the generator's last transposed conv produces the s2d form directly:
  its four output-parity classes land in four channel blocks;
- losses see ``fold_blocks`` of the s2d tensors, which keeps every
  per-(sample, class) pixel multiset a loss reduces over.

Everything takes the ORIGINAL parameters (OIHW conv, unflipped IOHW
convT), so checkpoints and state_dict keys are the same in both forms.

Kernel rearrangements (1-D, stride 2, k=4, p=1):

- down conv ``out[t] = sum_k x[2t + k - 1] w[k]``: input index 2t+k-1 is
  s2d row t + r - 1 (r in 0..2) at parity dy with k = 2r + dy - 1, so
  ``K[co, (dy, dx, ci), r, s] = w[co, ci, 2r+dy-1, 2s+dx-1]`` (zero where
  the index leaves 0..3);
- up conv with the unflipped weight, ``out[2t + d] = sum_r x[t-1+r]
  w[3 + d - 2r]`` where 0 <= 3+d-2r <= 3 (torch's convT; the JAX
  package's pre-flipped ``wf[k] = w[3 - k]``), so
  ``K[(dy, dx, co), ci, r, s] = w[ci, co, 3+dy-2r, 3+dx-2s]``.

``_conv3`` dispatches each stride-1 3x3 conv: Cin <= 32 (the thin regime
of the JAX gate, ``thin_conv.py:98``) runs kernel K4 (``thin_conv3x3``),
anything wider (the dec6 head's two convs, Cin = nf each, 64 at nf=64,
which the JAX package also leaves to XLA's conv) a cuDNN conv.
"""

import os

import torch
import torch.nn.functional as F

from .activations import apply_activation
from .kernels.thin_conv import MAX_CIN, thin_conv3x3

# the s2d form in the Trainer and the inference engine when PATCHGAN_S2D
# is unset
DEFAULT = 'off'


def s2d_enabled():
    """``PATCHGAN_S2D``, read as the JAX package reads it: off, 0 or false
    turn the form off, any other value on."""
    flag = os.environ.get('PATCHGAN_S2D', DEFAULT).lower()
    return flag not in ('off', '0', 'false')


def space_to_depth(x):
    """[N, C, 2H, 2W] -> [N, 4C, H, W], channel order (dy, dx, c)."""
    n, c, h2, w2 = x.shape
    h, w = h2 // 2, w2 // 2
    x = x.reshape(n, c, h, 2, w, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, 4 * c, h, w)


def depth_to_space(x):
    """[N, 4C, H, W] -> [N, C, 2H, 2W], the inverse of space_to_depth."""
    n, c4, h, w = x.shape
    c = c4 // 4
    x = x.reshape(n, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c, 2 * h, 2 * w)


def fold_blocks(x):
    """[N, 4C, H, W] s2d tensor -> [N, C, 4H, W]: the four parity blocks
    stacked along H. A copy in NCHW (the JAX package's is a free
    reshape), with the same per-(sample, class) pixel multisets as the
    full-resolution tensor."""
    n, c4, h, w = x.shape
    c = c4 // 4
    return x.reshape(n, 4, c, h, w).transpose(1, 2).reshape(n, c, 4 * h, w)


def apply_activation_s2d(x, name):
    """Activation of an s2d tensor, equal per original pixel: softmax
    runs over each parity block's C classes, elementwise ones pass
    through."""
    if name == 'softmax':
        n, c4, h, w = x.shape
        return torch.softmax(x.reshape(n, 4, c4 // 4, h, w), dim=2) \
            .reshape(n, c4, h, w)
    return apply_activation(x, name)


def down_kernel_s2d(w):
    """OIHW [Cout, Cin, 4, 4] k4/s2/p1 kernel -> [Cout, 4Cin, 3, 3] for
    the same conv as stride 1 on the s2d input."""
    cout, cin = w.shape[:2]
    # K[r, dy] = w[2r + dy - 1]: pad to 6 and read wp[2r + dy]
    wp = F.pad(w, (1, 1, 1, 1)).reshape(cout, cin, 3, 2, 3, 2)
    return wp.permute(0, 3, 5, 1, 2, 4).reshape(cout, 4 * cin, 3, 3)


def up_kernel_s2d(w):
    """Unflipped IOHW [Cin, Cout, 4, 4] convT kernel -> [4Cout, Cin, 3, 3]
    for the stride-1 conv that produces the s2d output."""
    cin, cout = w.shape[:2]
    # K[r, dy] = w[3 + dy - 2r] = wp[2(2 - r) + dy] with wp = pad(w, 1)
    wp = F.pad(w, (1, 1, 1, 1)).reshape(cin, cout, 3, 2, 3, 2)
    wp = wp.flip(2, 4)                              # [ci, co, r, dy, s, dx]
    return wp.permute(3, 5, 1, 0, 2, 4).reshape(4 * cout, cin, 3, 3)


def _conv3(x, k):
    """3x3 / stride-1 / pad-1 conv of x with the OIHW kernel k."""
    k = k.to(x.dtype)
    if x.shape[1] <= MAX_CIN:
        return thin_conv3x3(x, k)
    return F.conv2d(x, k, padding=1)


def conv2d_s2d(x, w, bias=None, x2=None, x2s=None):
    """conv2d(orig, w, stride=2, padding=1) on an s2d input.

    ``x`` (and ``x2``) are s2d tensors [N, 4C, H, W]; ``w`` is the
    ORIGINAL [Cout, C (+ C2), 4, 4] kernel. Equal to ``conv2d(
    depth_to_space(x), w, x2=depth_to_space(x2))``. ``x2s``, a tuple of
    second inputs, gives one output per mask with the x-part conv
    computed once and shared (the paired discriminator, models/disc.py).
    """
    c1 = x.shape[1] // 4
    b = bias.to(x.dtype) if bias is not None else None
    if x2s is not None:
        if x2 is not None:
            raise ValueError("conv2d_s2d: pass x2 or x2s, not both")
        shared = _conv3(x, down_kernel_s2d(w[:, :c1]))
        wm = down_kernel_s2d(w[:, c1:])
        outs = tuple(shared + _conv3(m.to(x.dtype), wm) for m in x2s)
        return outs if b is None else tuple(o + b.view(1, -1, 1, 1)
                                            for o in outs)
    if x2 is None:
        out = _conv3(x, down_kernel_s2d(w))
    else:
        out = _conv3(x, down_kernel_s2d(w[:, :c1])) + \
            _conv3(x2.to(x.dtype), down_kernel_s2d(w[:, c1:]))
    return out if b is None else out + b.view(1, -1, 1, 1)


def conv_transpose2d_s2d(x, w, bias=None, x2=None):
    """conv_transpose2d(x, w, stride=2, padding=1) with the output left in
    s2d form: [N, Cin, H, W] -> [N, 4Cout, H, W]. Equal to
    ``space_to_depth(conv_transpose2d(x, w, x2=x2))``."""
    if x2 is None:
        out = _conv3(x, up_kernel_s2d(w))
    else:
        c1 = x.shape[1]
        out = _conv3(x, up_kernel_s2d(w[:c1])) + \
            _conv3(x2.to(x.dtype), up_kernel_s2d(w[c1:]))
    if bias is not None:
        # the s2d channels are (dy, dx, c): the bias repeats per block
        out = out + bias.repeat(4).to(out.dtype).view(1, -1, 1, 1)
    return out
