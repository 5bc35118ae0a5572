"""K1: affine-free instance norm + activation, NCHW, and K1-bwd, its
backward.

Port of ``patchgan_tpu/ops/pallas/norm_act.py::instance_norm_act_pallas``:
the forward (``_fwd_kernel``) is ``csrc/norm_act.cu``, the backward
(``_bwd_kernel``) ``csrc/norm_act_bwd.cu``. ``instance_norm_act_plain``
and ``instance_norm_act_backward_plain`` are the same functions in plain
PyTorch, which the wrappers use for CPU tensors and the tests and
``chip_smoke.py`` hold the kernels against. ``InstanceNormAct`` is the
custom VJP (``norm_act.py:290-303``): its only residual is the input x,
and its backward recomputes the statistics from x.
"""

import ctypes
import functools

import torch

from ..activations import apply_activation
from . import _build

# the activations the three fused kernels implement, by kernel code
ACT_CODES = {None: 0, 'linear': 0, 'tanh': 1, 'relu': 2, 'leakyrelu': 3}


def act_code(name):
    if name not in ACT_CODES:
        raise ValueError(f"fused instance norm supports the activations "
                         f"{sorted(map(str, ACT_CODES))}, not {name!r}")
    return ACT_CODES[name]


def dtype_flag(t):
    """Kernel dtype switch: 1 for bfloat16, 0 for float32."""
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"kernels take float32 or bfloat16, not {t.dtype}")


def require(t, name, ndim, like=None):
    """Device, contiguity, rank and dtype checks before a launch."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if like is not None and (t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                         f"{like.dtype} on {like.device}")


def require_aligned(t, name):
    """K2's and K3's weights are read in 16-byte vectors; a fresh
    allocation starts on 16 bytes, a view need not."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def needs_graph(*tensors):
    """True when autograd must record this call: grad mode is on and an
    input requires grad. Otherwise (inference_mode, no_grad, constant
    inputs) a kernel runs bare and nothing is saved for a backward."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def instance_norm_act_plain(x, eps=1e-5, activation=None):
    """fp32 statistics per (n, c) plane, var = E[x^2] - mean^2, normalise
    in fp32, activate, cast back to x's dtype."""
    act_code(activation)
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return apply_activation(y, activation).to(x.dtype)


def act_grad(xhat, activation):
    """d act / d xhat, written out as the JAX package's ``_act_grad``
    (``norm_act.py:61-71``): relu' is 0 at 0, leakyrelu' is 1 at 0 (not
    the 0.2 that autograd of ``F.leaky_relu`` gives there)."""
    if activation in (None, 'linear'):
        return torch.ones_like(xhat)
    if activation == 'tanh':
        t = torch.tanh(xhat)
        return 1.0 - t * t
    if activation == 'relu':
        return (xhat > 0).to(xhat.dtype)
    if activation == 'leakyrelu':
        return torch.where(xhat >= 0, 1.0, 0.2).to(xhat.dtype)
    raise ValueError(activation)


def instance_norm_act_backward_plain(g, x, eps=1e-5, activation=None):
    """dx of ``instance_norm_act`` from the output gradient g and the
    input x (``_backward_xla``, norm_act.py:263-277): mean and rstd
    recomputed from x in fp32, gm = g * act'(xhat), dx = rstd * (gm -
    mean(gm) - xhat * mean(gm * xhat)), returned in g's dtype."""
    act_code(activation)
    xf, gf = x.float(), g.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    gm = gf * act_grad(xhat, activation)
    m1 = gm.mean(dim=(2, 3), keepdim=True)
    m2 = (gm * xhat).mean(dim=(2, 3), keepdim=True)
    return (rstd * (gm - m1 - xhat * m2)).to(g.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('norm_act')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pgt_in_act.argtypes = [p, p, ctypes.c_long, ctypes.c_long, i,
                               ctypes.c_float, i, p]
    lib.pgt_in_act.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = _build.load('norm_act_bwd')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pgt_in_act_bwd.argtypes = [p, p, p, ctypes.c_long, ctypes.c_long,
                                   i, ctypes.c_float, i, p]
    lib.pgt_in_act_bwd.restype = i
    return lib


def _forward(x, eps, activation):
    """K1 on a CUDA tensor, the plain version on a CPU tensor; never
    recorded by autograd."""
    if x.device.type == 'cpu':
        return instance_norm_act_plain(x, eps, activation)
    act = act_code(activation)
    require(x, 'x', 4)
    flag = dtype_flag(x)
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().pgt_in_act(x.data_ptr(), y.data_ptr(), n * c, h * w,
                               act, eps, flag, _build.stream_of(x))
    _build.check(rc, 'instance_norm_act')
    instance_norm_act.launches += 1
    return y


def instance_norm_act_backward(g, x, eps=1e-5, activation=None):
    """dx from g and x, both (N, C, H, W) of one dtype. A CPU tensor
    takes the plain version; a CUDA tensor launches K1-bwd."""
    if g.device.type == 'cpu':
        return instance_norm_act_backward_plain(g, x, eps, activation)
    act = act_code(activation)
    require(g, 'g', 4)
    require(x, 'x', 4, like=g)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} and x {tuple(x.shape)} "
                         f"differ")
    flag = dtype_flag(g)
    n, c, h, w = g.shape
    dx = torch.empty_like(g)
    with torch.cuda.device(g.device):
        rc = _bwd_lib().pgt_in_act_bwd(
            g.data_ptr(), x.data_ptr(), dx.data_ptr(), n * c, h * w, act,
            eps, flag, _build.stream_of(g))
    _build.check(rc, 'instance_norm_act_backward')
    instance_norm_act_backward.launches += 1
    return dx


instance_norm_act_backward.launches = 0


class InstanceNormAct(torch.autograd.Function):
    """K1 forward, K1-bwd backward; the residual is x alone."""

    @staticmethod
    def forward(ctx, x, eps, activation):
        ctx.save_for_backward(x)
        ctx.eps, ctx.activation = eps, activation
        return _forward(x, eps, activation)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        dx = instance_norm_act_backward(g.to(x.dtype).contiguous(), x,
                                        ctx.eps, ctx.activation)
        return dx, None, None


def instance_norm_act(x, eps=1e-5, activation=None):
    """x: (N, C, H, W). A CPU tensor takes the plain version; a CUDA
    tensor launches K1. Differentiable through ``InstanceNormAct``."""
    if needs_graph(x):
        return InstanceNormAct.apply(x, eps, activation)
    return _forward(x, eps, activation)


instance_norm_act.launches = 0
