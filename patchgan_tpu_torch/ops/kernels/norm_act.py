"""K1: affine-free instance norm + activation (forward), NCHW.

Port of ``patchgan_tpu/ops/pallas/norm_act.py::instance_norm_act_pallas``
(forward, ``_fwd_kernel``). The CUDA kernel is ``csrc/norm_act.cu``;
``instance_norm_act_plain`` beside it is the same function in plain
PyTorch, which the wrapper uses for CPU tensors and the tests and
``chip_smoke.py`` hold the kernel against.
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


def forward_only(*tensors):
    """The kernels have no backward yet: refuse a launch that autograd
    would have to differentiate, rather than return a result cut off
    from the graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA kernels are forward-only; run under "
            "torch.inference_mode() (training is a later ROADMAP item)")


def instance_norm_act_plain(x, eps=1e-5, activation=None):
    """fp32 statistics per (n, c) plane, var = E[x^2] - mean^2, normalise
    in fp32, activate, cast back to x's dtype."""
    act_code(activation)
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return apply_activation(y, activation).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('norm_act')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pgt_in_act.argtypes = [p, p, ctypes.c_long, ctypes.c_long, i,
                               ctypes.c_float, i, p]
    lib.pgt_in_act.restype = i
    return lib


def instance_norm_act(x, eps=1e-5, activation=None):
    """x: (N, C, H, W). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    if x.device.type == 'cpu':
        return instance_norm_act_plain(x, eps, activation)
    act = act_code(activation)
    require(x, 'x', 4)
    forward_only(x)
    flag = dtype_flag(x)
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().pgt_in_act(x.data_ptr(), y.data_ptr(), n * c, h * w,
                               act, eps, flag, _build.stream_of(x))
    _build.check(rc, 'instance_norm_act')
    instance_norm_act.launches += 1
    return y


instance_norm_act.launches = 0
