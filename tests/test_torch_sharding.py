"""The port's data x model parallelism (``patchgan_tpu_torch/parallel/
sharding.py``) on the CPU.

- Every parameter's sharding decision equals JAX
  ``model_parallel_shardings`` on the same models, through
  ``utils/transfer.py``'s key map and layouts; the rank grid equals JAX
  ``hybrid_mesh``'s device positions.
- The s2d kernels rearrange a Cout shard as the whole's rows, in the
  layout the model axis's gather stacks.
- The G+D step on spawned gloo ranks (``tests/torch_tp_worker.py``) at
  (dp, tp) = (1, 2) and (2, 2), nf=4, 128 px, global batch 8, fp32,
  dropout on, both forms, a replicated 3-class and a sharded 4-class
  softmax head: against one process on the whole batch within JAX's
  hybrid limits (``tests/test_distributed.py:98-116``: losses rtol 5e-4
  / atol 2e-5; parameters 99.9% within 2e-4 + 5e-3 |b|, all within
  2.5e-3); the first update's gradients, those of the replicated head
  and of the levels that feed it included, within 1e-4 of each tensor's
  max |g| of one process's (a gradient summed over the model group
  where it is whole already would be tp times too large); at (2, 2)
  against JAX's step on ``hybrid_mesh(2, 2)`` from JAX's initial
  weights, within the port's standing step limits
  (``tests/torch_parity.py``); and ``place_hybrid_state`` /
  ``gather_hybrid_state`` round trips bit for bit.
- ``patchgan_aot --tp 2 -d cpu`` on two ranks that see torchrun's
  environment, and its refusals.
"""

import concurrent.futures
import functools
import json

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker as dpw
import torch_parity
import torch_tp_worker as tpw
from patchgan_tpu_torch.models import Discriminator, UNet
from patchgan_tpu_torch.ops.s2d import down_kernel_s2d, up_kernel_s2d
from patchgan_tpu_torch.parallel import model_parallel_shardings, rank_grid
from patchgan_tpu_torch.parallel.mesh import channel_shard, stack_channels
from patchgan_tpu_torch.utils.transfer import disc_key_map

torch.set_num_threads(2)
GRIDS = [(1, 2), (2, 2)]
OUT_C = 4    # sharded at mp 2 and 4, replicated at 3


@functools.lru_cache(maxsize=None)
def _jax_params(nf, s2d, norm):
    """(generator, discriminator) parameter trees of the JAX models, as
    shapes only (``jax.eval_shape``)."""
    from patchgan_tpu.models import Discriminator as JaxDisc
    from patchgan_tpu.models import UNet as JaxUNet
    from patchgan_tpu.train.steps import init_train_state, make_optimizer
    gen = JaxUNet(input_nc=3, output_nc=OUT_C, nf=nf, final_act='softmax',
                  use_pallas=False, s2d=s2d)
    disc = JaxDisc(input_nc=3 + OUT_C, ndf=nf, n_layers=3, norm=norm,
                   use_pallas=False, s2d=s2d)
    state = jax.eval_shape(lambda: init_train_state(
        gen, disc, (1, 128, 128, 3), OUT_C, make_optimizer(1e-3),
        make_optimizer(1e-3)))
    return state.g_params, state.d_params


def _jax_decisions(params, mp, key_of, convt):
    """{port key: torch dim or None} from JAX's shardings: HWIO axis 3
    (O) is a conv's dim 0 and a transposed conv's dim 1, a bias's axis 0
    its dim 0."""
    from patchgan_tpu.parallel.sharding import (MODEL_AXIS, hybrid_mesh,
                                                model_parallel_shardings)
    shardings = model_parallel_shardings(params, hybrid_mesh(1, mp))
    out = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        names = [p.key for p in path]
        spec = tuple(sharding.spec)
        axis = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
        key = key_of(names)
        if axis is None:
            out[key] = None
        elif axis == 3:
            out[key] = 1 if convt(names) else 0
        else:
            assert axis == 0, (names, spec)
            out[key] = 0
    return out


def _unet_key(names):
    part, level = names[0][:3], names[0][3:]
    return (f'encoder.{level}.model.DownConv{level}.weight' if part == 'enc'
            else f'decoder.{level}.model.UpConv{level}.weight')


@functools.lru_cache(maxsize=None)
def _port_models(nf, norm):
    with torch.device('meta'):
        return (UNet(3, OUT_C, nf=nf),
                Discriminator(3 + OUT_C, ndf=nf, n_layers=3, norm=norm))


@pytest.mark.parametrize('norm', [False, True], ids=['no-norm', 'norm'])
@pytest.mark.parametrize('s2d', [False, True], ids=['plain', 's2d'])
@pytest.mark.parametrize('nf', [4, 64])
@pytest.mark.parametrize('mp', [2, 3, 4])
def test_shardings_match_jax(mp, nf, s2d, norm):
    """Leaf for leaf: sharded on the same axis, or replicated, as JAX's
    ``model_parallel_shardings`` decides for its TrainState."""
    g_params, d_params = _jax_params(nf, s2d, norm)
    gen, disc = _port_models(nf, norm)
    want_g = _jax_decisions(g_params, mp, _unet_key,
                            lambda names: names[0].startswith('dec'))
    keys = disc_key_map(3, norm)
    want_d = _jax_decisions(d_params, mp, lambda names: keys[names[0]],
                            lambda names: False)
    got_g = model_parallel_shardings(gen, mp)
    got_d = model_parallel_shardings(disc, mp)
    assert got_g == want_g
    assert got_d == want_d
    # both kinds of decision occur
    if mp == 2:
        assert got_g['decoder.6.model.UpConv6.weight'] == 1
        assert got_d['model.0.bias'] == 0
    assert got_d[keys['conv_out_kernel']] is None


@pytest.mark.parametrize('dp,mp', [(1, 2), (2, 2), (2, 4)])
def test_rank_grid_matches_jax(dp, mp):
    """World rank d * mp + m sits where JAX's ``hybrid_mesh`` puts device
    d * mp + m: the model axis innermost."""
    from patchgan_tpu.parallel.sharding import hybrid_mesh
    devices = hybrid_mesh(dp, mp).devices
    want = np.vectorize(lambda d: jax.devices().index(d))(devices)
    np.testing.assert_array_equal(rank_grid(dp, mp), want)


@pytest.mark.parametrize('tp', [2, 4])
def test_s2d_kernels_rearrange_a_shard(tp):
    """``down_kernel_s2d`` of a Cout shard is the whole's rows of those
    channels; ``up_kernel_s2d``'s is its (dy, dx, class) blocks' rows,
    which ``channel_shard`` / ``stack_channels`` (the gather's layout,
    four blocks) take apart and put back."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 5, 4, 4, generator=g)
    wt = torch.randn(5, 8, 4, 4, generator=g)
    down, up = down_kernel_s2d(w), up_kernel_s2d(wt)
    c = 8 // tp
    parts = []
    for r in range(tp):
        assert torch.equal(down_kernel_s2d(w[r * c:(r + 1) * c]),
                           down[r * c:(r + 1) * c])
        part = up_kernel_s2d(wt[:, r * c:(r + 1) * c])
        assert torch.equal(part, channel_shard(up[None], r, tp, 4)[0])
        parts.append(part[None])
    assert torch.equal(stack_channels(parts, 4)[0], up)
    assert torch.equal(stack_channels([t[None] for t in down.split(c)])[0],
                       down)


# the step on spawned ranks


@pytest.fixture(scope='module')
def tp_runs(tmp_path_factory):
    """({(dp, tp): the ranks' results}, {case: one process's run}, the
    JAX hybrid step's (losses, G, D)). The two grids run on spawned ranks
    while this process runs one process's cases and the JAX package's
    step on ``hybrid_mesh(2, 2)`` (``tests/test_distributed.py``'s
    set-up, dropout off)."""
    from patchgan_tpu.models import Discriminator as JaxDisc
    from patchgan_tpu.models import UNet as JaxUNet
    from patchgan_tpu.parallel.sharding import (hybrid_batch_sharding,
                                                hybrid_mesh,
                                                place_hybrid_state)
    from patchgan_tpu.train.steps import (init_train_state, make_optimizer,
                                          make_train_step)
    from patchgan_tpu_torch.utils.transfer import state_dict_from_jax
    gen = JaxUNet(input_nc=3, output_nc=1, nf=4, final_act='sigmoid',
                  use_pallas=False)
    disc = JaxDisc(input_nc=4, ndf=4, n_layers=2, use_pallas=False)
    gtx, dtx = make_optimizer(1e-3), make_optimizer(1e-3)
    state = init_train_state(gen, disc, (1, 128, 128, 3), 1, gtx, dtx,
                             seed=0)
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(8, 128, 128, 3)).astype(np.float32)
    y = (rng.uniform(size=(8, 128, 128, 1)) > 0.5).astype(np.float32)
    root = tmp_path_factory.mktemp('tp')
    weights = root / 'jax_weights.pt'
    torch.save(((state_dict_from_jax(jax.device_get(state.g_params)),
                 state_dict_from_jax(jax.device_get(state.d_params))),
                torch_parity.nchw(x), torch_parity.nchw(y)), weights)
    names = sorted(tpw.CASES)
    dirs = {grid: root / f'{grid[0]}x{grid[1]}' for grid in GRIDS}
    for folder in dirs.values():
        folder.mkdir()
    with concurrent.futures.ThreadPoolExecutor(len(GRIDS)) as pool:
        futures = [pool.submit(tpw.launch, tpw.step_cases, *grid,
                               dirs[grid], names,
                               str(weights) if grid == (2, 2) else None)
                   for grid in GRIDS]
        mesh = hybrid_mesh(2, 2)
        new, losses = jax.jit(make_train_step(gen, disc, gtx, dtx))(
            place_hybrid_state(state, mesh),
            jax.device_put(x, hybrid_batch_sharding(mesh)),
            jax.device_put(y, hybrid_batch_sharding(mesh)))
        jax_out = ({k: float(v) for k, v in losses.items()},
                   state_dict_from_jax(jax.device_get(new.g_params)),
                   state_dict_from_jax(jax.device_get(new.d_params)))
        single = {name: tpw.run_case(tpw.CASES[name]) for name in names}
        for f in futures:
            f.result()
    ranks = {grid: [torch.load(dirs[grid] / f'tp_{r}.pt', weights_only=False)
                    for r in range(grid[0] * grid[1])] for grid in GRIDS}
    return ranks, single, jax_out


def _assert_hybrid_close(want, got, what):
    """JAX's hybrid limits (``tests/test_distributed.py:110-116``)."""
    assert set(want) == set(got)
    for k in want:
        b, a = want[k].numpy(), got[k].numpy()
        diff = np.abs(a - b)
        tight = diff <= 2e-4 + 5e-3 * np.abs(b)
        assert np.mean(tight) >= 0.999, f'{what} {k}: {np.mean(~tight):.2%}'
        assert diff.max() <= 2.5e-3, f'{what} {k}: {diff.max():.3e}'


@pytest.mark.parametrize('name', sorted(tpw.CASES))
@pytest.mark.parametrize('grid', GRIDS, ids=['1x2', '2x2'])
def test_hybrid_step_matches_one_process(tp_runs, grid, name):
    """Every rank reports the same losses and gathers the same state;
    each step's losses and the parameters after the steps are within
    JAX's hybrid limits of one process's on the whole batch."""
    ranks, single, _ = tp_runs
    first = ranks[grid][0][name]
    for r in ranks[grid][1:]:
        assert r[name][0] == first[0]
        for i in (1, 2):
            assert all(torch.equal(r[name][i][k], first[i][k])
                       for k in first[i])
    losses, g, d, _ = single[name]
    for i, (want, got) in enumerate(zip(losses, first[0])):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=5e-4,
                                       atol=2e-5, err_msg=f'{k} at {i}')
    _assert_hybrid_close(g, first[1], 'generator')
    _assert_hybrid_close(d, first[2], 'discriminator')


@pytest.mark.parametrize('name', sorted(tpw.CASES))
@pytest.mark.parametrize('grid', GRIDS, ids=['1x2', '2x2'])
def test_first_update_gradients_match_one_process(tp_runs, grid, name):
    """The gradients the optimizers are handed at the first update,
    gathered, against one process's: the replicated heads' (G's 3-class
    head, D's conv_out) and the sharded levels' that feed them, which a
    sum over the model group of a gradient that is whole already would
    make tp times too large."""
    ranks, single, _ = tp_runs
    got = ranks[grid][0][name][3]
    want = single[name][3]
    gen, disc = tpw.build(tpw.CASES[name])[:2]
    for module, g_got, g_want in zip((gen, disc), got, want):
        names = [n for n, _ in module.named_parameters()]
        assert len(g_got) == len(g_want) == len(names)
        for key, a, b in zip(names, g_got, g_want):
            torch.testing.assert_close(
                a, b, rtol=0, atol=1e-4 * float(b.abs().max()),
                msg=lambda m, key=key: f'{key}: {m}')
    if tpw.CASES[name].get('out_c', dpw.OUT_C) % grid[1]:
        head = model_parallel_shardings(gen, grid[1])
        assert head['decoder.6.model.UpConv6.weight'] is None


def test_hybrid_step_matches_the_jax_hybrid_step(tp_runs):
    """The (2, 2) grid against the JAX package's step on
    ``hybrid_mesh(2, 2)``, from the same weights and batch, dropout off:
    the port's standing step limits."""
    ranks, _, (jax_losses, jax_g, jax_d) = tp_runs
    losses, g, d, _ = ranks[(2, 2)][0]['jax']
    torch_parity.assert_losses_close([jax_losses], losses)
    torch_parity.assert_params_close(jax_g, g)
    torch_parity.assert_params_close(jax_d, d)


@pytest.mark.parametrize('grid', GRIDS, ids=['1x2', '2x2'])
def test_place_and_gather_round_trip(tp_runs, grid):
    """``place_hybrid_state`` then ``gather_hybrid_state`` give back
    every parameter and moment (fp32, a bf16 first moment, an
    accumulator) bit for bit, on every rank; each rank sits at its
    (data, model) position of the grid."""
    ranks = tp_runs[0][grid]
    assert all(r['round_trip'] for r in ranks)
    dp, tp = grid
    assert [r['grid'] for r in ranks] == [(d, m) for d in range(dp)
                                          for m in range(tp)]


# patchgan_aot --tp


def _conv_flops(step, tp):
    """(FLOPs of every convolution and convolution backward of
    ``step()``, FLOPs with each whose output channels divide ``tp``
    divided by it): the sharded convs' share on one rank."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry
    aten = torch.ops.aten
    found = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            packet = func._overloadpacket
            if packet in (aten.convolution, aten.convolution_backward):
                weight, transposed = (args[1], args[6]) \
                    if packet is aten.convolution else (args[2], args[7])
                cout = weight.shape[1 if transposed else 0]
                flops = flop_registry[packet](*args, **(kwargs or {}),
                                              out_val=out)
                found.append((flops, cout))
            return out

    with Count():
        step()
    return (sum(f for f, _ in found),
            sum(f // tp if c % tp == 0 else f for f, c in found))


def _aot_args(tmp_path):
    import yaml
    path = tmp_path / 'aot.yaml'
    path.write_text(yaml.safe_dump({
        'dataset': {'type': 'NpzSegmentationDataset', 'size': 128,
                    'in_channels': 3, 'out_channels': 3},
        'model_params': {'generator': {'filters': 4},
                         'discriminator': {'filters': 4}},
        'train_params': {'loss_type': 'tversky', 'seg_alpha': 200}}))
    return ['-c', str(path), '--batch', '2', '-d', 'cpu', '--dtype',
            'float32', '--no-s2d']


def test_aot_tp_on_two_ranks(tmp_path):
    """``patchgan_aot --dp 1 --tp 2 -d cpu`` on two ranks: rank 0 prints
    the JSON line with the mesh {'data': 1, 'model': 2}; FLOPs per rank
    are the sharded convs' count over 2 plus the replicated ones whole
    (the 3-class head and conv_out), at the batch of a rank; the line of
    the activation gathers' bytes and bound is printed; rank 1 prints
    nothing."""
    from patchgan_tpu_torch.cli import aot
    argv = _aot_args(tmp_path) + ['--dp', '1', '--tp', '2']
    tpw.launch_aot(2, tmp_path, argv)
    (result, text), (_, text1) = [torch.load(tmp_path / f'aot_{r}.pt',
                                             weights_only=False)
                                  for r in range(2)]
    assert text1 == ''
    assert json.loads(text.strip().splitlines()[-1]) == \
        json.loads(json.dumps(result))
    assert result['mesh'] == {'data': 1, 'model': 2}
    assert result['devices'] == 2 and result['compile_ok'] is True
    gen, disc = aot._models(3, 3, {'filters': 4, 'use_dropout': True,
                                   'activation': 'relu',
                                   'final_activation': 'softmax'},
                            {'filters': 4, 'norm': False, 'n_layers': 3},
                            torch.float32, torch.device('cpu'))
    step, _ = aot._step(gen, disc, None, False,
                        dict(loss_type='tversky', seg_alpha=200.0,
                             bce_weighting='complement'), graph=False)
    x, y = aot._batch(1, 3, 3, 128, torch.float32, torch.device('cpu'))
    total, per_rank = _conv_flops(lambda: step(x, y), 2)
    assert per_rank < total
    assert result['cost']['flops_per_device'] == 2 * per_rank
    lines = [l for l in text.splitlines() if 'activation gathers' in l]
    assert len(lines) == 1 and 'MB a step' in lines[0] and \
        'NVLink' in lines[0], text


@pytest.mark.parametrize('world,flags,match', [
    (None, ['--tp', '2'], 'under torchrun'),
    ('3', ['--tp', '2'], '--dp 1 x --tp 2 .* world size is 3'),
    ('2', ['--dp', '2', '--tp', '2'], '--dp 2 x --tp 2 .* world size is 2')],
    ids=['outside-torchrun', 'world-3', 'world-2'])
def test_aot_tp_refuses(monkeypatch, world, flags, match):
    """Outside torchrun ``--tp`` says how to launch it; a world size that
    is not dp x tp raises naming the three numbers; both before any
    group forms."""
    from patchgan_tpu_torch.cli.aot import patchgan_aot
    for name in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK'):
        monkeypatch.delenv(name, raising=False)
    if world is not None:
        monkeypatch.setenv('WORLD_SIZE', world)
    with pytest.raises(ValueError, match=match):
        patchgan_aot(flags + ['-d', 'cpu'])
    assert not torch.distributed.is_initialized()
