"""K2: conv(k=4, s=2, p=1, no bias) + instance norm + activation, NCHW
input, OIHW weight, with its gradient.

Port of ``patchgan_tpu/ops/pallas/conv_norm_act.py::fused_conv_norm_act``.
The CUDA kernel is ``csrc/conv_norm_act.cu``; ``conv_norm_act_plain`` is
the same function in plain PyTorch (CPU tensors, tests, and the kernel's
oracle on the card). ``ConvNormAct`` is the custom VJP of
``conv_norm_act.py:194-211``: residuals (x, w); the backward recomputes
the conv output in the compute dtype (cuDNN; the JAX package leaves this
conv to XLA), runs K1-bwd on it, and takes dx and dw through the
recomputed conv.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .norm_act import (act_code, dtype_flag, instance_norm_act_backward,
                       instance_norm_act_plain, needs_graph, require,
                       require_aligned)


def conv_norm_act_plain(x, w, eps=1e-5, activation=None):
    """fp32 conv of the given values, then the fp32 norm and activation,
    cast back to x's dtype: the conv output is never rounded before the
    statistics, as in the kernel."""
    acc = F.conv2d(x.float(), w.float(), stride=2, padding=1)
    return instance_norm_act_plain(acc, eps, activation).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('conv_norm_act')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pgt_conv_in_act.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                    ctypes.c_float, i, p]
    lib.pgt_conv_in_act.restype = i
    lib.pgt_tile_m.argtypes = []
    lib.pgt_tile_m.restype = i
    lib.pgt_conv_splits.argtypes = [i] * 5
    lib.pgt_conv_splits.restype = i
    return lib


def _forward(x, w, eps, activation):
    """K2 on CUDA tensors, the plain version on CPU tensors; never
    recorded by autograd."""
    if x.device.type == 'cpu':
        return conv_norm_act_plain(x, w, eps, activation)
    act = act_code(activation)
    require(x, 'x', 4)
    require(w, 'w', 4, like=x)
    flag = dtype_flag(x)
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 4, 4):
        raise ValueError(f"w must be ({cout}, {cin}, 4, 4), got "
                         f"{tuple(w.shape)}")
    ho, wo = (h - 2) // 2 + 1, (wd - 2) // 2 + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"input {h}x{wd} is too small for k=4, s=2, p=1")
    require_aligned(w, 'w')
    lib = _lib()
    tiles = -(-ho * wo // lib.pgt_tile_m())
    y = torch.empty((n, cout, ho, wo), dtype=x.dtype, device=x.device)
    # fp32 conv output, one copy per K split
    splits = lib.pgt_conv_splits(n, cin, h, wd, cout)
    acc = torch.empty((splits, n, cout, ho, wo), dtype=torch.float32,
                      device=x.device)
    part = torch.empty((n, cout, tiles, 2), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.pgt_conv_in_act(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), acc.data_ptr(),
            part.data_ptr(), n, cin, h, wd, cout, act, eps, flag,
            _build.stream_of(x))
    _build.check(rc, 'conv_norm_act')
    conv_norm_act.launches += 1
    return y


def recompute_grads(ctx, g, conv, inputs):
    """The shared backward of K2 and K3: ``conv(*inputs)`` recomputed in
    the compute dtype, K1-bwd on it, then the input gradients that
    ``ctx.needs_input_grad`` asks for through the recomputed conv (None
    for the rest). ``recompute_grads.launches`` counts the recomputes."""
    want = [t is not None and need
            for t, need in zip(inputs, ctx.needs_input_grad)]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(inputs, want)]
        out = conv(*leaves)
    recompute_grads.launches += 1
    dout = instance_norm_act_backward(g.to(out.dtype).contiguous(),
                                      out.detach(), ctx.eps, ctx.activation)
    wanted = [t for t, need in zip(leaves, want) if need]
    found = iter(torch.autograd.grad(out, wanted, dout)) if wanted else None
    return [next(found) if need else None for need in want]


recompute_grads.launches = 0


def _conv(x, w):
    return F.conv2d(x, w, stride=2, padding=1)


class ConvNormAct(torch.autograd.Function):
    """K2 forward; backward by recompute + K1-bwd. Residuals (x, w)."""

    @staticmethod
    def forward(ctx, x, w, eps, activation):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.activation = eps, activation
        return _forward(x, w, eps, activation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = recompute_grads(ctx, g, _conv, (x, w))
        return dx, dw, None, None


def conv_norm_act(x, w, eps=1e-5, activation=None):
    """x: (N, Cin, H, W), w: (Cout, Cin, 4, 4) in x's dtype. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel.
    Differentiable through ``ConvNormAct``."""
    if needs_graph(x, w):
        return ConvNormAct.apply(x, w, eps, activation)
    return _forward(x, w, eps, activation)


conv_norm_act.launches = 0
