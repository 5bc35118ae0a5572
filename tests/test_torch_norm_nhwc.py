"""The NHWC forms' size dispatch (``nhwc_one_pass_plan``), which picks the
one-pass kernels (``csrc/norm_nhwc_cluster.cuh``) or the segmented ones
(``csrc/norm_nhwc.cuh``) on the host: the one-pass kernel at every shape
of config 2's step (batch 16, 256 px, nf=64: K1-bwd's 12 levels, K1 at
enc0) in bf16 and fp32, within a CTA's shared memory and the portable
cluster; the segmented kernels beyond a cluster's shared memory, for a C
that is no multiple of 8 or of a 32-byte tile, and for unaligned
pointers; the tiles cover every channel exactly once; the wrappers'
private ``_nhwc_kernel`` argument refuses what it cannot force. On the
CPU the wrappers take the plain versions whatever the argument says."""

import pytest
import torch

from patchgan_tpu_torch.ops.kernels import (instance_norm_act,
                                            instance_norm_act_backward)
from patchgan_tpu_torch.ops.kernels.norm_act import (
    CLUSTER_MAX, ONE_PASS_THREADS, _nhwc_choice, nhwc_one_pass_plan)

SMEM_PER_BLOCK = 232448     # an H100 block's shared memory, 227 KB
B, F = 16, 64
# (N, C, H, W) of the 12 K1-bwd calls of one generator backward at batch
# 16, 256 px, nf=64 (chip_smoke.bwd_shapes); K1 runs at enc0
STEP = {'enc0': (B, F, 128, 128), 'enc1': (B, 2 * F, 64, 64),
        'enc2': (B, 4 * F, 32, 32), 'enc3': (B, 8 * F, 16, 16),
        'enc4': (B, 8 * F, 8, 8), 'enc5': (B, 8 * F, 4, 4),
        'enc6': (B, 8 * F, 2, 2), 'dec1': (B, 8 * F, 8, 8),
        'dec2': (B, 8 * F, 16, 16), 'dec3': (B, 4 * F, 32, 32),
        'dec4': (B, 2 * F, 64, 64), 'dec5': (B, F, 128, 128)}
CASES = [(f'K1-bwd {k}', s, 2) for k, s in STEP.items()] + \
    [('K1 enc0', STEP['enc0'], 1)]
# the spatial 1024-px level beyond a cluster (8 MB a 32-byte tile of x)
BEYOND = (2, 64, 512, 512)
DTYPES = [torch.bfloat16, torch.float32]


def _plan(shape, dtype, inputs, aligned=True):
    n, c, h, w = shape
    return nhwc_one_pass_plan(n, h * w, c, dtype, inputs, aligned)


@pytest.mark.parametrize('dtype', DTYPES, ids=['bf16', 'fp32'])
@pytest.mark.parametrize('label,shape,inputs', CASES,
                         ids=[c[0] for c in CASES])
def test_one_pass_takes_every_step_shape(label, shape, inputs, dtype):
    n, c, h, w = shape
    plan = _plan(shape, dtype, inputs)
    assert plan is not None, label
    width = 16 // dtype.itemsize
    # the tile: 16-byte chunks, at least 32 bytes of a pixel or all of it
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= 32
    assert plan.lanes * 16 >= 32 or plan.lanes * width == c
    # the cluster and the CTA's shared memory
    assert 1 <= plan.cluster <= CLUSTER_MAX
    assert plan.grid == (plan.cluster, plan.tiles, n)
    assert plan.seg_len * plan.cluster >= h * w > \
        plan.seg_len * (plan.cluster - 1)
    # the staged segments, the mbarriers and the reduction buffers
    cw = plan.lanes * width
    red = 16 + (ONE_PASS_THREADS // 32 + 2 * plan.cluster + 2) * cw * 8
    assert plan.smem == red + plan.seg_len * plan.lanes * 16 * inputs
    assert plan.smem <= SMEM_PER_BLOCK
    # the tiles cover every channel once: tile t holds [t cw, (t + 1) cw)
    covered = [ch for t in range(plan.tiles) for lane in range(plan.lanes)
               for ch in range(t * cw + lane * width,
                               t * cw + (lane + 1) * width)]
    assert covered == list(range(c))
    # every CTA of the cluster has pixels
    assert (plan.cluster - 1) * plan.seg_len < h * w


@pytest.mark.parametrize('dtype', DTYPES, ids=['bf16', 'fp32'])
@pytest.mark.parametrize('why,shape,inputs,aligned', [
    ('K1-bwd beyond a cluster', BEYOND, 2, True),
    ('K1 beyond a cluster', BEYOND, 1, True),
    ('C no multiple of 8', (2, 60, 16, 16), 2, True),
    ('C no multiple of 8, K1', (3, 5, 4, 4), 1, True),
    ('unaligned', (2, 16, 16, 16), 2, False),
])
def test_segmented_takes_the_rest(why, shape, inputs, aligned, dtype):
    assert _plan(shape, dtype, inputs, aligned) is None, why


def test_bf16_tile_of_32_bytes_or_the_whole_pixel():
    """24 bf16 channels (48 bytes) split into neither 32-byte tiles nor
    one chunk: segmented; 8 (16 bytes, the whole pixel): one-pass."""
    assert _plan((2, 24, 8, 8), torch.bfloat16, 2) is None
    assert _plan((2, 24, 8, 8), torch.float32, 2) is not None
    plan = _plan((2, 8, 8, 8), torch.bfloat16, 2)
    assert plan is not None and plan.lanes == 1 and plan.tiles == 1


@pytest.mark.parametrize('shape', [(16, 512, 2, 2), (16, 512, 4, 4),
                                   (16, 512, 8, 8), (1, 64, 1, 1)])
def test_deep_levels_widen_the_tile(shape):
    """The 1-64-pixel levels take tiles of 128 bytes (or the whole pixel),
    so a CTA's threads have chunks, each CTA a row of threads' pixels."""
    n, c, h, w = shape
    plan = _plan(shape, torch.bfloat16, 2)
    chunks = c // 8
    assert plan.lanes == min(8, chunks) or \
        h * w * plan.lanes >= 2 * ONE_PASS_THREADS
    assert plan.cluster == 1 or \
        plan.seg_len >= ONE_PASS_THREADS // plan.lanes


def test_choice_forces_and_refuses():
    x = torch.empty(64)
    args = (16, 128 * 128, 64, torch.bfloat16, 2, x)
    assert _nhwc_choice(None, *args) == _plan(STEP['enc0'], torch.bfloat16,
                                              2)
    assert _nhwc_choice('one_pass', *args) is not None
    assert _nhwc_choice('segmented', *args) is None
    big = (2, 512 * 512, 64, torch.bfloat16, 2, x)
    assert _nhwc_choice(None, *big) is None
    with pytest.raises(ValueError, match='cannot take'):
        _nhwc_choice('one_pass', *big)
    with pytest.raises(ValueError, match='_nhwc_kernel'):
        _nhwc_choice('fast', *args)


@pytest.mark.parametrize('kernel', [None, 'one_pass', 'segmented'])
def test_cpu_wrappers_take_the_plain_versions(kernel):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 8, 8, generator=g).contiguous(
        memory_format=torch.channels_last)
    dy = torch.randn(2, 16, 8, 8, generator=g).contiguous(
        memory_format=torch.channels_last)
    want = instance_norm_act(x, 1e-5, 'relu')
    got = instance_norm_act(x, 1e-5, 'relu', _nhwc_kernel=kernel)
    assert torch.equal(got, want)
    want = instance_norm_act_backward(dy, x, 1e-5, 'relu')
    got = instance_norm_act_backward(dy, x, 1e-5, 'relu', _nhwc_kernel=kernel)
    assert torch.equal(got, want)
