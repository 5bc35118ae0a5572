"""K4-wgrad's two kernels on the CPU: the host planner that picks one
(``thin_wgrad_plan``), a mirror of the C planner's walk (the tiles each
block walks and the partial it fills) and of the reduce's order, and
plain emulations of both kernels' sums held against the plain wgrad
and, through ``thin_conv3x3``'s backward, against the JAX package's
Pallas ``thin_conv3x3`` (interpret mode).

On the card (``csrc/thin_conv.cu``) a bf16 call with W % 8 == 0 and x and
dy on 16 bytes runs ``thin_wgrad_tma``: one block an SM walks tiles of 4
output rows x 64 columns with the grid's stride; TMA copies each tile's
dy rows and its 6 haloed x rows, and the threads build two more copies
of those shifted by a column; per output row, 16-pixel slice and shift
s one wgmma of N = 3 CP (tap rows 0-2 x CP channels) adds into that
shift's accumulators; at the end each
thread stores its accumulator fragment into the block's partial
[64][9 CP] (tap 3 r + s, CP = Cin rounded up to 16 or 32), and
``thin_wgrad_reduce`` adds the partials in a fixed order. The rest (bf16
off 16 bytes or W % 8 != 0, and fp32) runs the WMMA / FMA kernel over
tiles of 2 rows into the same partial layout. Here every (sample, pixel,
tap) must be summed exactly once, every partial element stored once, and
the emulated partials, added in the reduce's order, must give the plain
dw within 1e-5 x max(1, max |dw|); dw through ``thin_conv3x3`` on CPU
tensors must give the JAX vjp within rtol 1e-4 / atol 2e-3.
"""

import ctypes
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchgan_tpu_torch.ops.kernels import (thin_conv3x3,
                                            thin_conv3x3_wgrad,
                                            thin_conv3x3_wgrad_plain)

tc = importlib.import_module('patchgan_tpu_torch.ops.kernels.thin_conv')

torch.set_num_threads(2)
BF16, FP32 = torch.bfloat16, torch.float32
# (N, Cin, H, W, Cout): the issue's shapes (Cin 12 and 28 at 128-wide
# rows, Cout 40, the ragged 40 x 70), the s2d step's two shapes, few
# tiles, Cout over two blocks
SHAPES = [(2, 12, 32, 64, 64), (1, 28, 32, 128, 64), (2, 12, 32, 64, 40),
          (3, 4, 40, 70, 28), (16, 12, 128, 128, 64),
          (16, 28, 128, 128, 64), (1, 12, 6, 8, 64), (2, 20, 10, 16, 130)]
SMALL = SHAPES[:4]


def _id(shape):
    n, cin, h, w, cout = shape
    return f'{n}x{cin}x{h}x{w}-{cout}'


# the C planner's walk and the reduce's order, mirrored (csrc/thin_conv.cu)
RED_ROWS = 8   # rows of thin_wgrad_reduce's block


def wgrad_grid(plan, sms=132, per_sm=1):
    """Blocks along the tiles of a launch on a card of ``sms`` SMs that
    holds ``per_sm`` blocks of the kernel an SM (the wgmma kernel's: 1):
    the persistent grid, shared by the Cout blocks, at most the tiles."""
    return min(plan.tiles, max(1, per_sm * sms // plan.cblks))


def wgrad_walk(plan, h, w, grid):
    """Block (bx, by) of a launch of ``grid`` blocks along the tiles:
    {(bx, by): (partial slot, [(sample, row0, col0) of each tile it sums,
    in order])}. Tile t of the plan's route is (sample, rows row0 ..
    row0 + th - 1, columns col0 .. col0 + tw - 1), columns fastest; block
    bx walks t = bx, bx + grid, ...; its partial is slot bx * cblks +
    by."""
    th, tw = tc.WGRAD_TILE[plan.route]
    across, down = -(-w // tw), -(-h // th)
    out = {}
    for bx in range(grid):
        tiles = [(t // (across * down), t // across % down * th,
                  t % across * tw) for t in range(bx, plan.tiles, grid)]
        for by in range(plan.cblks):
            out[(bx, by)] = (bx * plan.cblks + by, tiles)
    return out


def wgrad_reduce_order(nblk):
    """The order in which thin_wgrad_reduce adds ``nblk`` partials into
    each dw element: row r of its block sums partials r, r + 8, ... in
    order, then the 8 row sums are added in row order. A list of the rows'
    lists of partial slots (of one Cout block; slots are bx * cblks +
    by)."""
    return [list(range(r, nblk, RED_ROWS)) for r in range(RED_ROWS)]


@pytest.mark.parametrize('shape', SHAPES, ids=_id)
def test_plan_route_by_shape_and_alignment(shape):
    """bf16 with W % 8 == 0 and both inputs on 16 bytes takes the wgmma
    kernel (CP 16 to Cin 16, else 32; three ring stages at CP 16, two at
    32, within an H100 block's shared memory); W % 8 != 0 or an input off
    16 bytes the WMMA kernel, fp32 the FMA kernel; the tiles cover the
    image at the route's tile size."""
    n, cin, h, w, cout = shape
    for aligned in (True, False):
        plan = tc.thin_wgrad_plan(n, cin, h, w, cout, BF16, aligned)
        want = 'wgmma' if aligned and w % 8 == 0 else 'wmma'
        assert plan.route == want
        assert plan.cp == (16 if cin <= 16 else 32)
        if want == 'wgmma':
            assert plan.stages == (3 if cin <= 16 else 2)
            assert plan.smem <= tc.WGRAD_SMEM_MAX
            assert plan.smem == plan.stages * (
                4 * 64 * 128 + 3 * 6 * plan.cp * 128
                + 2 * 6 * plan.cp * 16) + 1024
        else:
            assert plan.stages == plan.smem == 0
        th, tw = tc.WGRAD_TILE[plan.route]
        assert plan.tiles == n * -(-h // th) * -(-w // tw)
        assert plan.cblks == -(-cout // 64)
    plan = tc.thin_wgrad_plan(n, cin, h, w, cout, FP32)
    assert (plan.route, plan.cp) == ('fma', cin)


def _grids(plan):
    """An H100's persistent grid (132 SMs, one block an SM) and a small
    one whose blocks walk several tiles."""
    return sorted({wgrad_grid(plan), wgrad_grid(plan, 5)})


def _tile_taps(plan, tiles, h, w):
    """The (sample, pixel row, pixel column, tap) index arrays the
    ``tiles`` contract, as the route's kernel walks a tile: the wgmma
    kernel per output row, per 16-pixel slice of the 64 columns and per
    shift s, one wgmma over tap rows 0-2 (taps 3 r + s); the WMMA kernel
    per 16 pixels, every tap. Pixels outside the image carry zero dy and
    are dropped."""
    th, tw = tc.WGRAD_TILE[plan.route]
    t = np.asarray(tiles).reshape(-1, 3)
    r = np.arange(th)[None, :, None]
    c = (16 * np.arange(tw // 16)[:, None] + np.arange(16)).ravel()
    taps = (3 * np.arange(3)[None, :] + np.arange(3)[:, None]).ravel()
    y = t[:, 1, None, None] + r                    # [tiles, th, 1]
    x = t[:, 2, None, None] + c[None, None, :]     # [tiles, 1, tw]
    y, x = np.broadcast_arrays(y, x)
    s = np.broadcast_to(t[:, 0, None, None], y.shape)
    keep = (y < h) & (x < w)
    s, y, x = s[keep], y[keep], x[keep]
    return (np.repeat(s, 9), np.repeat(y, 9), np.repeat(x, 9),
            np.tile(taps, s.size))


@pytest.mark.parametrize('dtype', [BF16, FP32], ids=['bf16', 'fp32'])
@pytest.mark.parametrize('shape', SHAPES, ids=_id)
def test_walk_covers_each_pixel_and_tap_once(shape, dtype):
    """Under the plan's walk, at an H100's grid and a small one: every
    (sample, pixel, tap) of the image summed exactly once by the blocks of
    each Cout block, each block filling its own partial slot (bx cblks +
    by, all distinct and within the scratch of grid x cblks partials)."""
    n, cin, h, w, cout = shape
    plan = tc.thin_wgrad_plan(n, cin, h, w, cout, dtype)
    for grid in _grids(plan):
        walk = wgrad_walk(plan, h, w, grid)
        slots = sorted(slot for slot, _ in walk.values())
        assert slots == list(range(grid * plan.cblks))
        for by in range(plan.cblks):
            seen = np.zeros((n, h, w, 9), np.int32)
            tiles = [t for bx in range(grid) for t in walk[(bx, by)][1]]
            np.add.at(seen, _tile_taps(plan, tiles, h, w), 1)
            assert (seen == 1).all()


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _inputs(shape, seed):
    n, cin, h, w, cout = shape
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(n, cin, h, w)).astype(np.float32))
    dy = _bf16(rng.normal(size=(n, cout, h, w)).astype(np.float32))
    return x, dy


def _tile_sum(plan, x, dy, tile, by):
    """One tile's fp32 sum into the 64 output channels of Cout block by:
    [64, 9, CP], tap 3 r + s, zero past Cin and Cout."""
    n, cin, h, w = x.shape
    cout = dy.shape[1]
    th, tw = tc.WGRAD_TILE[plan.route]
    s_, row0, col0 = tile
    pad = np.zeros((cin, h + th + 2, w + tw + 2), np.float32)
    pad[:, 1:h + 1, 1:w + 1] = x[s_]
    d = np.zeros((64, th, tw), np.float32)
    co = slice(64 * by, min(64 * by + 64, cout))
    rows, cols = min(th, h - row0), min(tw, w - col0)
    d[:co.stop - co.start, :rows, :cols] = \
        dy[s_, co, row0:row0 + rows, col0:col0 + cols]
    out = np.zeros((64, 9, plan.cp), np.float32)
    for r in range(3):
        for s in range(3):
            v = pad[:, row0 + r:row0 + r + th, col0 + s:col0 + s + tw]
            out[:, 3 * r + s, :cin] = d.reshape(64, -1) @ \
                v.reshape(cin, -1).T
    return out


def _wgmma_epilogue(acc, cp):
    """The wgmma kernel's store of a block's accumulators (acc[s] the
    [64, 3 CP] D of shift s, columns r CP + ci) into its partial [64 x 9
    CP], thread by thread as csrc/thin_conv.cu writes its fragment; every
    element must be written once."""
    part = np.full(64 * 9 * cp, np.nan, np.float32)
    written = np.zeros(64 * 9 * cp, np.int32)
    tid = np.arange(128)
    row = (tid >> 5) * 16 + ((tid & 31) >> 2)
    c2 = 2 * (tid & 3)
    for s in range(3):
        for q in range(3 * cp // 8):
            rr, ci = 8 * q // cp, 8 * q % cp + c2
            o = row * 9 * cp + (3 * rr + s) * cp + ci
            col = 8 * q + c2
            for off, dr in ((0, 0), (8 * 9 * cp, 8)):
                for k in range(2):
                    part[o + off + k] = acc[s][row + dr, col + k]
                    np.add.at(written, o + off + k, 1)
    assert (written == 1).all()
    return part.reshape(64, 9, cp)


def emulate_wgrad(plan, x, dy, grid):
    """K4-wgrad in the card's order under ``plan`` and ``grid`` (fp32):
    each block's tiles summed in walk order into its partial (on the
    wgmma route through the accumulators and the kernel's epilogue), then
    the reduce: row r of each output element's block sums partials r, r +
    8, ... in order, and the rows are added in order. dw [Cout, Cin, 3,
    3]."""
    n, cin, h, w = x.shape
    cout = dy.shape[1]
    cp = plan.cp
    parts = {}
    for (bx, by), (slot, tiles) in wgrad_walk(plan, h, w,
                                                      grid).items():
        acc = np.zeros((64, 9, cp), np.float32)
        for tile in tiles:
            acc = acc + _tile_sum(plan, x, dy, tile, by)
        if plan.route == 'wgmma':
            # D of shift s: columns r CP + ci hold tap 3 r + s
            d = [acc[:, s::3].reshape(64, 3 * cp) for s in range(3)]
            acc = _wgmma_epilogue(d, cp)
        parts[(bx, by)] = acc
    dw = np.zeros((cout, cin, 9), np.float32)
    for by in range(plan.cblks):
        rows = []
        for slots in wgrad_reduce_order(grid):
            s = np.zeros((64, 9, cp), np.float32)
            for bx in slots:
                s = s + parts[(bx, by)]
            rows.append(s)
        total = np.zeros((64, 9, cp), np.float32)
        for s in rows:
            total = total + s
        co = slice(64 * by, min(64 * by + 64, cout))
        dw[co] = np.transpose(total[:co.stop - co.start, :, :cin], (0, 2, 1))
    return torch.from_numpy(dw.reshape(cout, cin, 3, 3))


@pytest.mark.parametrize('shape', SMALL, ids=_id)
def test_emulated_partials_match_plain(shape):
    """bf16-valued inputs in fp32: the partials emulated in the plan's
    order (the wgmma route, or the WMMA route for the ragged 40 x 70), at
    an H100's grid and a small one, added in the reduce's order, within
    1e-5 x max(1, max |dw|) of ``thin_conv3x3_wgrad_plain``."""
    n, cin, h, w, cout = shape
    x, dy = _inputs(shape, 70 + cin)
    want = thin_conv3x3_wgrad_plain(torch.from_numpy(x),
                                    torch.from_numpy(dy))
    plan = tc.thin_wgrad_plan(n, cin, h, w, cout, BF16)
    assert plan.route == ('wmma' if w % 8 else 'wgmma')
    for grid in _grids(plan):
        got = emulate_wgrad(plan, x, dy, grid)
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * max(1.0, want.abs().max().item()), (grid, err)


# the JAX comparison needs H a multiple of the Pallas kernel's 32-row
# chunk (_BH): the ragged case at 32 x 70 (W % 8 != 0: the WMMA route)
JAX_SHAPES = [(2, 12, 32, 64, 64), (1, 28, 32, 128, 64), (2, 12, 32, 64, 40),
              (3, 4, 32, 70, 28)]


@pytest.mark.parametrize('shape', JAX_SHAPES, ids=_id)
def test_dw_matches_pallas_vjp(shape, monkeypatch):
    """fp32 on CPU tensors: dw of sum(sin(thin_conv3x3(x, w))) through
    ``ThinConv3x3``'s backward (``thin_conv3x3_wgrad``) against the JAX
    ``thin_conv3x3``'s in interpret mode within rtol 1e-4 / atol 2e-3;
    the wrapper counts no launch on the CPU."""
    monkeypatch.setenv('PATCHGAN_THIN_CONV', 'interpret')
    from patchgan_tpu.ops.pallas.thin_conv import thin_conv3x3 as jax_thin
    n, cin, h, w, cout = shape
    rng = np.random.default_rng(80 + cin)
    xa = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    wa = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    x = torch.from_numpy(np.transpose(xa, (0, 3, 1, 2)).copy())
    wt = torch.from_numpy(np.transpose(wa, (3, 2, 0, 1)).copy()) \
        .requires_grad_()
    before = (thin_conv3x3_wgrad.launches,
              thin_conv3x3_wgrad.launches_wgmma)
    dw, = torch.autograd.grad(torch.sin(thin_conv3x3(x, wt)).sum(), (wt,))
    assert (thin_conv3x3_wgrad.launches,
            thin_conv3x3_wgrad.launches_wgmma) == before
    jdw = jax.grad(lambda b: jnp.sum(jnp.sin(jax_thin(jnp.asarray(xa), b))))(
        jnp.asarray(wa))
    np.testing.assert_allclose(np.transpose(dw.numpy(), (2, 3, 1, 0)),
                               np.asarray(jdw), rtol=1e-4, atol=2e-3)


class _Lib:
    """Stands in for a ctypes library: records each entry's argtypes."""

    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, type('Entry', (), {})())


C_TYPES = {'void*': ctypes.c_void_p, 'int': ctypes.c_int,
           'long': ctypes.c_long, 'float': ctypes.c_float}


def c_entries(source):
    """{name: [the ctypes type of each parameter]} of the extern "C"
    functions of csrc/``source``.cu and the headers it may include; an
    int* parameter is POINTER(c_int)."""
    csrc = os.path.join(os.path.dirname(tc.__file__), '..', '..', 'csrc')
    text = ''
    for name in sorted(os.listdir(csrc)):
        if name == f'{source}.cu' or name.endswith('.cuh'):
            with open(os.path.join(csrc, name)) as f:
                text += f.read()
    out = {}
    for name, params in re.findall(r'extern "C" \w+\s+(\w+)\(([^)]*)\)',
                                   text):
        kinds = []
        for p in params.split(','):
            p = ' '.join(p.replace('const ', '').split())
            if not p or p == 'void':
                continue
            ctype = p.rsplit(' ', 1)[0].replace(' *', '*')
            if p.split()[-1].startswith('*'):
                ctype += '*'
            kinds.append(ctypes.POINTER(ctypes.c_int) if ctype == 'int*'
                         else C_TYPES[ctype])
        out[name] = kinds
    return out


def test_ctypes_entries_match_their_c_declarations(monkeypatch):
    """Each argtypes list ``thin_conv``'s wrappers give the library names
    the C entry point's parameters in order (a mismatch shows only as a
    TypeError or a wrong launch on the card)."""
    lib = _Lib()
    monkeypatch.setattr(tc._build, 'load', lambda name: lib)
    tc._lib.__wrapped__()
    declared = c_entries('thin_conv')
    assert 'pgt_thin_conv_wgrad' in lib.entries
    for name, entry in lib.entries.items():
        assert list(entry.argtypes) == declared[name], name
