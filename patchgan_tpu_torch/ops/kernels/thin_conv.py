"""K4 and K4-wgrad: the thin-channel 3x3 / stride-1 / pad-1 convolution,
NCHW input, OIHW weight, and its weight gradient.

Port of ``patchgan_tpu/ops/pallas/thin_conv.py::thin_conv3x3``: the
forward (``_forward``, ``_fwd_kernel``) and the weight gradient
(``_wgrad``, ``_wgrad_kernel``) are ``csrc/thin_conv.cu``. The input
gradient is a cuDNN conv, as the JAX package's ``_dgrad`` is an XLA conv
(``thin_conv.py:179-188, 233-238``). ``thin_conv3x3_plain`` and
``thin_conv3x3_wgrad_plain`` are the same functions in plain PyTorch,
which the wrappers use for CPU tensors and the tests and ``chip_smoke.py``
hold the kernels against. Each forward launch first packs the weight
into the layout its blocks copy to shared memory
(``pack_thin_weight_plain`` is that layout in plain PyTorch,
``pack_thin_weight`` the pack kernel alone; both for tests and
``chip_smoke.py``). ``ThinConv3x3`` is the custom VJP
(``thin_conv.py:241-263``): residuals (x, w); dw by K4-wgrad in fp32,
cast to w's dtype; dx by the conv of dy with the flipped kernel.

K4-wgrad takes one of two kernels, by shape and alignment alone
(``thin_wgrad_plan``): in bf16 where W % 8 == 0 and x and dy lie on 16
bytes (the s2d step's calls), ``thin_wgrad_tma`` on the wgmma path, fed
by TMA, one block an SM over tiles of 4 output rows x 64 columns; else
the WMMA kernel (bf16) or the FMA kernel (fp32), over tiles of 2 rows.
Each block sums its tiles into one fp32 partial and a reduce adds the
partials in a fixed order (tests/test_torch_thin_wgrad.py mirrors the
walk and the order). ``thin_conv3x3_wgrad.launches_wgmma`` counts the
wgmma kernel's launches.
"""

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .norm_act import dtype_flag, needs_graph, require

# widest input the kernels take: the upper edge of the JAX gate's thin
# regime (thin_conv.py:98)
MAX_CIN = 32
BLOCK_N = 64   # output channels of a kernel block (BN of csrc/thin_conv.cu)
# row stride of the packed weight: bf16 pads 8 channels (LDW), fp32 none
PACKED_ROW = {torch.bfloat16: BLOCK_N + 8, torch.float32: BLOCK_N}
# K4-wgrad's tiles (output rows x columns): the wgmma kernel's (TH_W, TW
# of csrc/thin_conv.cu) and the WMMA / FMA kernel's (TH, TW)
WGRAD_TILE = {'wgmma': (4, 64), 'wmma': (2, 64), 'fma': (2, 64)}
# the wgmma kernel's shared memory: an H100 block's, a ring stage (4
# output rows of dy, 64 channels x 128 bytes each; 3 column shifts of 6
# haloed rows of x, CP channels x 128 bytes; 2 halos of 16 bytes a row
# and channel), at most 4 stages
WGRAD_SMEM_MAX = 232448


def _wgrad_stage(cp):
    return 4 * BLOCK_N * 128 + 3 * 6 * cp * 128 + 2 * 6 * cp * 16


ThinWgradPlan = collections.namedtuple(
    'ThinWgradPlan', 'route cp stages smem tiles cblks')


@functools.lru_cache(maxsize=None)
def thin_wgrad_plan(n, cin, h, w, cout, dtype, aligned=True):
    """K4-wgrad's kernel for x (n, cin, h, w) and dy (n, cout, h, w) of
    ``dtype``, as csrc/thin_conv.cu's run_wgrad picks it: ``route``
    'wgmma' (thin_wgrad_tma) in bf16 where W % 8 == 0 and x and dy are
    ``aligned`` on 16 bytes, else 'wmma' (bf16) or 'fma' (fp32). ``cp``:
    the partial's columns a tap (Cin rounded up to 16 or 32 in bf16, Cin
    in fp32); ``stages`` and ``smem``: the wgmma kernel's ring (0
    elsewhere); ``tiles``: the output tiles the blocks share; ``cblks``:
    the blocks of 64 output channels."""
    if dtype == torch.bfloat16:
        route = 'wgmma' if aligned and w % 8 == 0 else 'wmma'
        cp = 16 if cin <= 16 else 32
    else:
        route, cp = 'fma', cin
    stages = smem = 0
    if route == 'wgmma':
        stages = min(4, (WGRAD_SMEM_MAX - 1024) // _wgrad_stage(cp))
        smem = stages * _wgrad_stage(cp) + 1024
    th, tw = WGRAD_TILE[route]
    tiles = n * -(-h // th) * -(-w // tw)
    return ThinWgradPlan(route, cp, stages, smem, tiles, -(-cout // BLOCK_N))


def thin_conv3x3_plain(x, w):
    """fp32 conv of the given values, cast back to x's dtype."""
    return F.conv2d(x.float(), w.float(), padding=1).to(x.dtype)


def thin_conv3x3_wgrad_plain(x, dy):
    """fp32 dw [Cout, Cin, 3, 3] of the conv, as the Pallas kernel
    contracts it: sum over samples of dy_n [Cout, H W] @ patches_n^T, the
    patches [9 Cin, H W] ordered (ci, r, s) as OIHW."""
    cin, cout = x.shape[1], dy.shape[1]
    patches = F.unfold(x.float(), 3, padding=1)
    dw = torch.einsum('nop,nkp->ok', dy.float().flatten(2), patches)
    return dw.reshape(cout, cin, 3, 3)


def pack_thin_weight_plain(w, dtype):
    """K4's packed weight in ``dtype``: (ceil(Cout / 64), 9, Ks, ldw) with
    wp[cb, tap, ci, c] = w[64 cb + c, ci, tap // 3, tap % 3], Ks = Cin
    rounded up to 16 and ldw = ``PACKED_ROW[dtype]``; zero where ci >=
    Cin, c >= 64 or 64 cb + c >= Cout."""
    cout, cin = w.shape[:2]
    ks = -(-cin // 16) * 16
    cblks = -(-cout // BLOCK_N)
    full = torch.zeros(cblks * BLOCK_N, ks, 9, dtype=dtype, device=w.device)
    full[:cout, :cin] = w.reshape(cout, cin, 9).to(dtype)
    wp = full.reshape(cblks, BLOCK_N, ks, 9).permute(0, 3, 2, 1)
    return F.pad(wp, (0, PACKED_ROW[dtype] - BLOCK_N)).contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('thin_conv')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pgt_thin_conv_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.pgt_thin_conv_fwd.restype = i
    lib.pgt_thin_conv_pack.argtypes = [p, p, i, i, i, p]
    lib.pgt_thin_conv_pack.restype = i
    lib.pgt_thin_conv_packed_size.argtypes = [i, i, i]
    lib.pgt_thin_conv_packed_size.restype = i
    lib.pgt_thin_conv_grid.argtypes = [i] * 7 + [ctypes.POINTER(i)]
    lib.pgt_thin_conv_grid.restype = i
    lib.pgt_thin_conv_wgrad_scratch.argtypes = [i] * 6
    lib.pgt_thin_conv_wgrad_scratch.restype = ctypes.c_long
    lib.pgt_thin_conv_wgrad.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.pgt_thin_conv_wgrad.restype = i
    return lib


def _require_thin(x):
    if x.shape[1] > MAX_CIN:
        raise ValueError(f"thin conv takes at most {MAX_CIN} input "
                         f"channels, got {x.shape[1]}")


def _packed(lib, w):
    """An empty buffer for w's packed form."""
    cout, cin = w.shape[:2]
    return torch.empty(lib.pgt_thin_conv_packed_size(cin, cout,
                                                     dtype_flag(w)),
                       dtype=w.dtype, device=w.device)


def pack_thin_weight(w):
    """The pack kernel alone on a CUDA weight (Cout, Cin, 3, 3): what K4
    packs before its conv, in the shape of ``pack_thin_weight_plain``, to
    hold against it. Not a K4 launch."""
    require(w, 'w', 4)
    if w.shape[2:] != (3, 3) or w.shape[1] > MAX_CIN:
        raise ValueError(f"w must be (Cout, Cin <= {MAX_CIN}, 3, 3), got "
                         f"{tuple(w.shape)}")
    lib = _lib()
    cout, cin = w.shape[:2]
    wp = _packed(lib, w)
    with torch.cuda.device(w.device):
        rc = lib.pgt_thin_conv_pack(w.data_ptr(), wp.data_ptr(), cin, cout,
                                    dtype_flag(w), _build.stream_of(w))
    _build.check(rc, 'thin conv pack')
    return wp.view(-(-cout // BLOCK_N), 9, -(-cin // 16) * 16,
                   PACKED_ROW[w.dtype])


def thin_conv_grid(x, cout, wgrad=False):
    """(blocks along the tiles, blocks an SM holds) of the K4 (or, with
    ``wgrad``, K4-wgrad) launch for CUDA input x and Cout on x's card."""
    lib = _lib()
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        grid = lib.pgt_thin_conv_grid(*x.shape, cout, dtype_flag(x),
                                      int(wgrad), ctypes.byref(per_sm))
    return grid, per_sm.value


def _forward(x, w):
    """K4 on CUDA tensors, the plain version on CPU tensors; never
    recorded by autograd."""
    if x.device.type == 'cpu':
        return thin_conv3x3_plain(x, w)
    require(x, 'x', 4)
    require(w, 'w', 4, like=x)
    _require_thin(x)
    flag = dtype_flag(x)
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3):
        raise ValueError(f"w must be ({cout}, {cin}, 3, 3), got "
                         f"{tuple(w.shape)}")
    lib = _lib()
    y = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device)
    wp = _packed(lib, w)
    with torch.cuda.device(x.device):
        rc = lib.pgt_thin_conv_fwd(x.data_ptr(), w.data_ptr(), wp.data_ptr(),
                                   y.data_ptr(), n, cin, h, wd, cout, flag,
                                   _build.stream_of(x))
    _build.check(rc, 'thin_conv3x3')
    thin_conv3x3.launches += 1
    return y


def thin_conv3x3_wgrad(x, dy):
    """fp32 dw [Cout, Cin, 3, 3] from x (N, Cin, H, W) and dy (N, Cout,
    H, W) of one dtype. A CPU tensor takes the plain version; a CUDA
    tensor launches K4-wgrad on ``thin_wgrad_plan``'s kernel."""
    if x.device.type == 'cpu':
        return thin_conv3x3_wgrad_plain(x, dy)
    require(x, 'x', 4)
    require(dy, 'dy', 4, like=x)
    _require_thin(x)
    flag = dtype_flag(x)
    n, cin, h, wd = x.shape
    cout = dy.shape[1]
    if dy.shape != (n, cout, h, wd):
        raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}")
    lib = _lib()
    plan = thin_wgrad_plan(n, cin, h, wd, cout, x.dtype,
                           x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0)
    dw = torch.empty((cout, cin, 3, 3), dtype=torch.float32,
                     device=x.device)
    with _build.device_guard(x):
        # one partial per block of the grid, which is sized for this card
        part = torch.empty(lib.pgt_thin_conv_wgrad_scratch(n, cin, h, wd,
                                                           cout, flag),
                           dtype=torch.float32, device=x.device)
        rc = lib.pgt_thin_conv_wgrad(x.data_ptr(), dy.data_ptr(),
                                     part.data_ptr(), dw.data_ptr(), n, cin,
                                     h, wd, cout, flag, _build.stream_of(x))
    _build.check(rc, 'thin_conv3x3_wgrad')
    thin_conv3x3_wgrad.launches += 1
    thin_conv3x3_wgrad.launches_wgmma += plan.route == 'wgmma'
    return dw


thin_conv3x3_wgrad.launches = 0
thin_conv3x3_wgrad.launches_wgmma = 0


class ThinConv3x3(torch.autograd.Function):
    """K4 forward; dw by K4-wgrad and dx by a cuDNN conv, each only where
    ``ctx.needs_input_grad`` asks for it. Residuals (x, w)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = F.conv_transpose2d(g, w.to(g.dtype), padding=1)
        if ctx.needs_input_grad[1]:
            dw = thin_conv3x3_wgrad(x, g).to(w.dtype)
        return dx, dw


def thin_conv3x3(x, w):
    """x: (N, Cin, H, W) with Cin <= 32, w: (Cout, Cin, 3, 3) in x's
    dtype. A CPU tensor takes the plain version; a CUDA tensor launches
    K4. Differentiable through ``ThinConv3x3``."""
    if needs_graph(x, w):
        return ThinConv3x3.apply(x, w)
    return _forward(x, w)


thin_conv3x3.launches = 0
