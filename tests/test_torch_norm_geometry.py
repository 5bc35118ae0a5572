"""K1's and K1-bwd's launch geometry (``plane_geometry``), which the
wrappers pass to the kernels: every shape of the main path and the edge
shapes map to a class, the grid covers every plane once, each plane's
chunks go to its group's lanes exactly once, and the 16-byte path is
taken only where a plane's bytes are a multiple of 16 and the pointers
are aligned."""

import pytest
import torch

from patchgan_tpu_torch.ops.kernels.norm_act import (HELD, MAX_GROUP,
                                                     plane_geometry)

# (N, C, H, W): the 12 K1-bwd calls of one generator backward at batch 16,
# 256 px, nf=64 (chip_smoke.bwd_shapes), K1 at enc0 (an 8-tile inference
# chunk and the batch-16 step), and the edge shapes of the kernel tests
MAIN = {'enc0': (16, 64, 128, 128), 'enc1': (16, 128, 64, 64),
        'enc2': (16, 256, 32, 32), 'enc3': (16, 512, 16, 16),
        'enc4': (16, 512, 8, 8), 'enc5': (16, 512, 4, 4),
        'enc6': (16, 512, 2, 2), 'dec1': (16, 512, 8, 8),
        'dec2': (16, 512, 16, 16), 'dec3': (16, 256, 32, 32),
        'dec4': (16, 128, 64, 64), 'dec5': (16, 64, 128, 128),
        'K1 chunk': (8, 64, 128, 128)}
EDGE = {'4x4': (3, 5, 4, 4), '8x8': (2, 8, 8, 8), '16x16': (2, 4, 16, 16),
        '1x3': (2, 8, 1, 3), '6x10': (2, 8, 6, 10), '1x1': (4, 8, 1, 1),
        '33 planes': (1, 33, 32, 32), '64x64': (1, 3, 64, 64),
        '256x256': (2, 3, 256, 256), '24x40': (16, 64, 24, 40)}
SHAPES = {**MAIN, **EDGE}
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize('dtype', DTYPES, ids=['bf16', 'fp32'])
@pytest.mark.parametrize('label', list(SHAPES))
def test_geometry_covers_every_plane_once(label, dtype):
    n, c, h, w = SHAPES[label]
    planes, plane = n * c, h * w
    geo = plane_geometry(planes, plane, dtype)
    esize = dtype.itemsize
    assert geo.cls in ('lanes', 'block', 'stream')
    # the 16-byte path exactly where the plane's bytes allow it
    assert geo.vec == (plane * esize % 16 == 0)
    width = 16 // esize if geo.vec else 1
    chunks = plane // width
    assert chunks * width == plane
    # group: a power of two; lanes share a warp, a block is the group
    g = geo.group
    assert g & (g - 1) == 0 and 1 <= g <= MAX_GROUP
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= MAX_GROUP
    if geo.cls == 'lanes':
        assert g <= 32 and geo.threads % g == 0
    else:
        assert g > 32 and geo.threads == g
    assert geo.per_thread in HELD
    # the grid: every plane in one block, no block without a plane
    per_block = geo.threads // g
    assert geo.grid * per_block >= planes > (geo.grid - 1) * per_block
    # the chunks of a plane: lane l holds k * group + l for k < per_thread
    # and reads l + group * j past them; each chunk exactly once
    held = geo.per_thread * g
    seen = sorted([k * g + lane for lane in range(g)
                   for k in range(geo.per_thread) if k * g + lane < chunks]
                  + list(range(held, chunks)))
    assert seen == list(range(chunks))
    # registers hold the whole plane unless the class says otherwise
    assert (held < chunks) == (geo.cls == 'stream')
    if geo.cls == 'stream':
        assert g == MAX_GROUP


@pytest.mark.parametrize('label', ['enc0', '4x4', '64x64'])
def test_geometry_unaligned_goes_element_by_element(label):
    n, c, h, w = SHAPES[label]
    for dtype in DTYPES:
        assert plane_geometry(n * c, h * w, dtype).vec
        geo = plane_geometry(n * c, h * w, dtype, aligned=False)
        assert not geo.vec and geo.cls in ('lanes', 'block', 'stream')


def test_geometry_classes_of_the_main_path():
    """The bf16 train step's levels: lanes for the deep levels (several
    planes a warp up to 16 x 16, a warp a plane at 32 x 32), one block a
    plane at 64 x 64 and 128 x 128, every plane held in registers."""
    want = {(128, 128): 'block', (64, 64): 'block', (32, 32): 'lanes',
            (16, 16): 'lanes', (8, 8): 'lanes', (4, 4): 'lanes',
            (2, 2): 'lanes'}
    for label, (n, c, h, w) in MAIN.items():
        geo = plane_geometry(n * c, h * w, torch.bfloat16)
        assert geo.cls == want[h, w], label
        if h <= 16:
            assert geo.group < 32, label     # several planes a warp
