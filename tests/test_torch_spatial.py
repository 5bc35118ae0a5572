"""The port's spatial parallelism (``patchgan_tpu_torch/parallel/
spatial.py``) on the CPU.

- The band operations on spawned gloo ranks (``tests/torch_sp_worker.py``)
  at sp 2 and 4: ``halo``, ``band_sum``, ``gather_band`` and
  ``split_band``, forward and backward (and ``shard_batch_spatial`` /
  ``replicate_spatial``), against the same function on the
  whole tensor, and convs over haloed bands against the rows of the whole
  conv (k4/s2 and the discriminator's k4/s1 ``H - 1`` rule), within 1e-6
  of max(1, max |b|) in fp32; the discriminator's band forward, split and
  whole, within 1e-5 (its instance norms divide by a band-summed std).
- The band kernels' plain stage versions over 2 and 3 bands: the summed
  stats, apply and bwd-sums against the whole-plane plain versions of K1,
  K1-bwd, K2 and K3, rtol 1e-5 / atol 1e-6.
- The spatial G+D step at (1, 2), (2, 2) and (2, 4) (the last over-sharded:
  the UNet gathers its deep levels): against the JAX package's
  single-device step from its weights and batch at the JAX spatial test's
  limits (``tests/test_distributed.py:199-210``), and against the port's
  one-process step (losses rtol 1e-4 / atol 1e-6, the first update's
  gradients within 1e-4 of each tensor's max |g|, parameters within the
  JAX limits); dropout on at (1, 2), its masks bit-equal to one process's
  global draw.

The Trainer, ``patchgan_train`` and the refusals are in
``tests/test_torch_spatial_train.py``.
"""

import concurrent.futures
import contextlib
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_dp_worker as dpw
import torch_parity
import torch_sp_worker as spw
from patchgan_tpu_torch.ops.kernels import (
    conv_band_plain, conv_norm_act_plain, convt_band_plain,
    convt_norm_act_plain, in_apply_plain, in_bwd_apply_plain,
    in_bwd_sums_plain, in_stats_plain, instance_norm_act_backward_plain,
    instance_norm_act_plain)
from patchgan_tpu_torch.models.unet import gather_level

torch.set_num_threads(2)
GRIDS = [(1, 2), (2, 2), (2, 4)]
OPS = ['halo', 'band_sum', 'gather_band', 'split_band', 'k4s2', 'k4s1',
       'api']


# the band operations


@pytest.fixture(scope='module')
def op_runs(tmp_path_factory):
    """{sp: the ranks' errors} of ``torch_sp_worker.band_ops`` on (1, 2)
    and (1, 4) grids."""
    folders = {sp: tmp_path_factory.mktemp(f'ops{sp}') for sp in (2, 4)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(spw.launch, spw.band_ops, 1, sp, folder)
                  for sp, folder in folders.items()]:
            f.result()
    return {sp: [torch.load(folder / f'ops_{r}.pt') for r in range(sp)]
            for sp, folder in folders.items()}


@pytest.mark.parametrize('op', OPS)
@pytest.mark.parametrize('sp', [2, 4])
def test_band_op_matches_the_whole_tensor(op_runs, sp, op):
    """Forward and backward of each band operation on every rank, within
    1e-6 of max(1, max |b|) of the whole tensor's (fp32; a summed weight
    gradient over the group); 'api': ``shard_batch_spatial`` gives the
    rank's rows and band, ``replicate_spatial`` rank 0's values."""
    for rank, errs in enumerate(op_runs[sp]):
        mine = {k: v for k, v in errs.items() if k.split()[0] == op}
        assert len(mine) >= 2, errs
        for k, v in mine.items():
            assert v <= 1e-6, f'rank {rank} {k}: {v:.3e}'


@pytest.mark.parametrize('form', ['split', 'whole'])
@pytest.mark.parametrize('sp', [2, 4])
def test_disc_bands_match_the_whole_disc(op_runs, sp, form):
    """The paired discriminator with norm on over bands (the ``H - 1`` rule
    at its stride-1 layers), and gathered where its bands are too short,
    against the whole forward: each rank's output rows, its inputs'
    gradients and the summed weight gradients."""
    for rank, errs in enumerate(op_runs[sp]):
        mine = {k: v for k, v in errs.items()
                if k.startswith(f'disc {form} ')}
        assert len(mine) == 3, errs
        for k, v in mine.items():
            assert v <= 1e-5, f'rank {rank} {k}: {v:.3e}'


# the plain stage versions of the band kernels


def _bands(h, n):
    return [(i * h // n, (i + 1) * h // n) for i in range(n)]


def _haloed(x, lo, hi):
    """Rows [lo - 1, hi + 1) of x, zero beyond the image (what
    ``SpatialAxis.halo`` hands a band)."""
    return F.pad(x, (0, 0, 1, 1))[:, :, lo:hi + 2]


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('act', ['relu', 'tanh', 'leakyrelu', None])
@pytest.mark.parametrize('n_bands', [2, 3])
def test_k1_band_stages(n_bands, act):
    """K1: each band's stats summed, then apply on each band, concatenated,
    equal ``instance_norm_act_plain``; K1-bwd: bwd-sums with the global
    stats, summed, then bwd-apply, equal
    ``instance_norm_act_backward_plain``."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 12, 10, generator=g) * 2 + 0.5
    gy = torch.randn(2, 5, 12, 10, generator=g)
    bands = _bands(12, n_bands)
    count = 12 * 10
    stats = sum(in_stats_plain(x[:, :, a:b]) for a, b in bands)
    y = torch.cat([in_apply_plain(x[:, :, a:b], stats, count, 1e-5, act)
                   for a, b in bands], dim=2)
    _close(y, instance_norm_act_plain(x, 1e-5, act))
    sums = sum(in_bwd_sums_plain(gy[:, :, a:b], x[:, :, a:b], stats, count,
                                 1e-5, act) for a, b in bands)
    dx = torch.cat([in_bwd_apply_plain(gy[:, :, a:b], x[:, :, a:b], stats,
                                       sums, count, 1e-5, act)
                    for a, b in bands], dim=2)
    _close(dx, instance_norm_act_backward_plain(gy, x, 1e-5, act))


@pytest.mark.parametrize('act', ['leakyrelu', None])
@pytest.mark.parametrize('n_bands', [2, 3])
def test_k2_band_stages(n_bands, act):
    """K2 over haloed bands of even rows (zero halo rows at the image's
    edges): the bands' summed stats applied to each band's output,
    concatenated, equal ``conv_norm_act_plain``."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 6, 24, 16, generator=g)
    w = torch.randn(7, 6, 4, 4, generator=g) * 0.2
    parts = [conv_band_plain(_haloed(x, a, b), w)
             for a, b in _bands(24, n_bands)]
    stats = sum(s for _, s in parts)
    count = 12 * 8
    y = torch.cat([in_apply_plain(acc, stats, count, 1e-5, act)
                   for acc, _ in parts], dim=2)
    _close(y, conv_norm_act_plain(x, w, 1e-5, act))


@pytest.mark.parametrize('act', ['relu', 'tanh'])
@pytest.mark.parametrize('n_bands', [2, 3])
def test_k3_band_stages(n_bands, act):
    """K3 over haloed bands of x and skip: the bands' summed stats applied
    to each band's 2h output rows, concatenated, equal
    ``convt_norm_act_plain``."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 9, 8, generator=g)
    skip = torch.randn(2, 3, 9, 8, generator=g)
    w = torch.randn(9, 5, 4, 4, generator=g) * 0.2
    parts = []
    for a, b in _bands(9, n_bands):
        parts.append(convt_band_plain(_haloed(x, a, b), w,
                                      _haloed(skip, a, b)))
    stats = sum(s for _, s in parts)
    count = 18 * 16
    y = torch.cat([in_apply_plain(acc, stats, count, 1e-5, act)
                   for acc, _ in parts], dim=2)
    _close(y, convt_norm_act_plain(x, w, 1e-5, act, skip))


def _band_plan():
    """``chip_smoke.band_plan``: the launches its phase 17b holds each
    rank's step to."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chip_smoke.py')
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.band_plan


def test_gather_level_and_plan():
    """The first UNet level whose input rows do not split into bands of an
    even number of rows, and the per-step launches it implies
    (``chip_smoke.band_plan``): at 128 px over 2, enc6 (whose input has 2
    rows); over 4, enc5 (4 rows); at 256 px over 2 and at 1024 px over 2
    and 4 nothing gathers."""
    band_plan = _band_plan()
    assert gather_level(128, 2) == 6 and gather_level(128, 4) == 5
    assert gather_level(256, 2) == gather_level(1024, 4) == 7
    plan = band_plan(256, 2)
    assert plan == dict(plan, in_stats=1, in_apply=12, conv_band=6,
                        convt_band=5, in_bwd_sums=12, in_bwd_apply=12,
                        conv_norm_act=0, convt_norm_act=0,
                        instance_norm_act_backward=0)
    plan = band_plan(128, 4)
    # enc0-4 and dec2-5 on bands; enc5-6, dec0 and dec1 whole
    assert (plan['conv_band'], plan['conv_norm_act'], plan['convt_band'],
            plan['convt_norm_act'], plan['instance_norm_act_backward']) == \
        (4, 2, 4, 1, 3)


@pytest.mark.parametrize('dp,sp', GRIDS)
def test_rank_grid_matches_jax_spatial_mesh(dp, sp):
    """World rank d * sp + s sits where JAX's ``spatial_mesh`` puts device
    d * sp + s: the spatial axis innermost. (JAX's ``spatial_mesh``
    switches its process to the GSPMD partitioner; restored after.)"""
    from patchgan_tpu.parallel.spatial import spatial_mesh
    from patchgan_tpu_torch.parallel import rank_grid
    shardy = jax.config.jax_use_shardy_partitioner
    try:
        with pytest.warns(UserWarning) if shardy else contextlib.nullcontext():
            devices = spatial_mesh(dp, sp).devices
    finally:
        jax.config.update('jax_use_shardy_partitioner', shardy)
    want = np.vectorize(lambda d: jax.devices().index(d))(devices)
    np.testing.assert_array_equal(rank_grid(dp, sp), want)


# the step on spawned ranks


def _jax_setup():
    """The JAX package's spatial test's set-up (tests/test_distributed.py
    :17-29): (its state, its jitted single-device step, x, y)."""
    from patchgan_tpu.models import Discriminator as JaxDisc
    from patchgan_tpu.models import UNet as JaxUNet
    from patchgan_tpu.train.steps import (init_train_state, make_optimizer,
                                          make_train_step)
    gen = JaxUNet(input_nc=3, output_nc=1, nf=4, final_act='sigmoid',
                  use_pallas=False)
    disc = JaxDisc(input_nc=4, ndf=4, n_layers=2, use_pallas=False)
    gtx, dtx = make_optimizer(1e-3), make_optimizer(1e-3)
    state = init_train_state(gen, disc, (1, 128, 128, 3), 1, gtx, dtx,
                             seed=0)
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(8, 128, 128, 3)).astype(np.float32)
    y = (rng.uniform(size=(8, 128, 128, 1)) > 0.5).astype(np.float32)
    return state, jax.jit(make_train_step(gen, disc, gtx, dtx)), x, y


@pytest.fixture(scope='module')
def sp_runs(tmp_path_factory):
    """({grid: the ranks' results}, {case: one process's run}, the JAX
    single-device step's (losses, G, D), one process's dropout run and
    masks). The three grids run on spawned ranks while this process runs
    the JAX step and one process's cases."""
    from patchgan_tpu_torch.utils.transfer import state_dict_from_jax
    state, step, x, y = _jax_setup()
    root = tmp_path_factory.mktemp('sp')
    weights = root / 'jax_weights.pt'
    torch.save(((state_dict_from_jax(jax.device_get(state.g_params)),
                 state_dict_from_jax(jax.device_get(state.d_params))),
                torch_parity.nchw(x), torch_parity.nchw(y)), weights)
    names = sorted(spw.CASES)
    dirs = {grid: root / f'{grid[0]}x{grid[1]}' for grid in GRIDS}
    for folder in dirs.values():
        folder.mkdir()
    with concurrent.futures.ThreadPoolExecutor(len(GRIDS)) as pool:
        futures = [pool.submit(spw.launch, spw.step_cases, *grid,
                               dirs[grid], names, str(weights),
                               grid == (1, 2)) for grid in GRIDS]
        new, losses = step(state, x, y)
        jax_out = ({k: float(v) for k, v in losses.items()},
                   state_dict_from_jax(jax.device_get(new.g_params)),
                   state_dict_from_jax(jax.device_get(new.d_params)))
        single = {name: spw.run_case(spw.CASES[name], steps=1)
                  for name in names}
        dropout = spw.dropout_reference()
        for f in futures:
            f.result()
    ranks = {grid: [torch.load(dirs[grid] / f'steps_{r}.pt',
                               weights_only=False)
                    for r in range(grid[0] * grid[1])] for grid in GRIDS}
    return ranks, single, jax_out, dropout


def _assert_jax_spatial_limits(want, got, what):
    """``tests/test_distributed.py:205-210``: 99.9% of each tensor within
    2e-4 + 5e-3 |b|, every element within 2.5e-3."""
    assert set(want) == set(got)
    for k in want:
        b, a = want[k].numpy(), got[k].numpy()
        diff = np.abs(a - b)
        tight = diff <= 2e-4 + 5e-3 * np.abs(b)
        assert np.mean(tight) >= 0.999, f'{what} {k}: {np.mean(~tight):.2%}'
        assert diff.max() <= 2.5e-3, f'{what} {k}: {diff.max():.3e}'


def _assert_ranks_agree(results):
    """Every rank reports the same losses and holds the same state."""
    first = results[0]
    for r in results[1:]:
        assert r[0] == first[0] and r[1] == first[1]
        for i in (2, 3):
            assert all(torch.equal(r[i][k], first[i][k]) for k in first[i])


@pytest.mark.parametrize('grid', GRIDS, ids=['1x2', '2x2', '2x4'])
def test_spatial_step_matches_the_jax_step(sp_runs, grid):
    """The spatial step from the JAX package's initial weights on its
    batch against its single-device step (the JAX spatial test's case):
    losses within rtol 5e-4 / atol 2e-5, G and D within its parameter
    limits; every rank alike; each rank at its (data, spatial) place."""
    ranks, _, (jax_losses, jax_g, jax_d), _ = sp_runs
    results = [r['jax'] for r in ranks[grid]]
    _assert_ranks_agree(results)
    losses, _, g, d, _ = results[0]
    for k in ('gen', 'gdisc', 'discr', 'discf', 'disc'):
        np.testing.assert_allclose(losses[0][k], jax_losses[k], rtol=5e-4,
                                   atol=2e-5, err_msg=k)
    _assert_jax_spatial_limits(jax_g, g, 'generator')
    _assert_jax_spatial_limits(jax_d, d, 'discriminator')
    dp, sp = grid
    assert [r['grid'] for r in ranks[grid]] == [(i, j) for i in range(dp)
                                                for j in range(sp)]


@pytest.mark.parametrize('name', sorted(spw.CASES))
@pytest.mark.parametrize('grid', GRIDS, ids=['1x2', '2x2', '2x4'])
def test_spatial_step_matches_one_process(sp_runs, grid, name):
    """One step and an eval step of each loss case against one process on
    the whole batch: losses (IoU included) within rtol 1e-4 / atol 1e-6;
    the first update's gradients, summed over the grid, within 1e-4 of
    each tensor's max |g| (a level gathered with a slicing backward would
    drop the other bands' parts; a gradient summed where it is whole
    would be sp times too large); the parameters within the JAX spatial
    test's limits."""
    ranks, single, _, _ = sp_runs
    results = [r[name] for r in ranks[grid]]
    _assert_ranks_agree(results)
    losses, ev, g, d, grads = single[name]
    r0 = results[0]
    for i, (want, got) in enumerate(zip(losses + [ev], r0[0] + [r0[1]])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=f'{k} at {i}')
    for got, want in zip(r0[4], grads):
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-4 * float(b.abs().max()))
    _assert_jax_spatial_limits(g, r0[2], 'generator')
    _assert_jax_spatial_limits(d, r0[3], 'discriminator')


def test_spatial_dropout_matches_one_process(sp_runs):
    """Dropout on, two steps at (1, 2): every mask a rank draws is its
    band of one process's global draw, bit for bit, and the losses and
    parameters match one process's as without dropout."""
    ranks, _, _, ((losses, ev, g, d, _), masks) = sp_runs
    for r in ranks[(1, 2)]:
        got = r['masks']
        assert len(got) == len(masks) > 0
        s = r['grid'][1]
        for mine, whole in zip(got, masks):
            h = whole.shape[2]
            if mine.shape[2] == h:      # a level that runs whole
                assert torch.equal(mine, whole)
            else:
                assert mine.shape[2] * 2 == h
                assert torch.equal(mine, whole[:, :, s * h // 2:
                                               (s + 1) * h // 2])
    r0 = ranks[(1, 2)][0]['dropout']
    for want, got in zip(losses + [ev], r0[0] + [r0[1]]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    _assert_jax_spatial_limits(g, r0[2], 'generator')
    _assert_jax_spatial_limits(d, r0[3], 'discriminator')
