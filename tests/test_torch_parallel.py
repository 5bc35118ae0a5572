"""The port's data parallelism (``patchgan_tpu_torch/parallel/``) on the
CPU: per-rank index slices against the JAX package's, the loader's
per-rank batches and the dropout masks against one process's, bit for
bit, and the data-parallel G+D step on two gloo ranks (spawned, on a
free port, every join with a timeout) against one process on the
concatenated batch, with the JAX DP test's limits (losses rtol 2e-4 /
atol 1e-5, parameters rtol 5e-3 / atol 2e-4,
``tests/test_distributed.py:53-64``), for every loss type and weighting,
in both forms, frozen and accumulating; and against the JAX package's
step on its 8-device mesh within the port's standing step limits
(``tests/torch_parity.py``). nf=4, 128 px, global batch 8, fp32.
"""

import weakref

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker as dpw
import torch_parity
from patchgan_tpu.parallel.multihost import \
    process_local_range as jax_range
from patchgan_tpu_torch.data import DataLoader
from patchgan_tpu_torch.models.blocks import dropout
from patchgan_tpu_torch.parallel import DataMesh, process_local_range

torch.set_num_threads(2)


@pytest.mark.parametrize('batch', [8, 10, 12, 16])
@pytest.mark.parametrize('count', [1, 2, 3, 4])
def test_process_local_range_matches_jax(batch, count):
    for index in range(count):
        if batch % count:
            with pytest.raises(ValueError, match='must divide'):
                jax_range(batch, index, count)
            with pytest.raises(ValueError, match='must divide'):
                process_local_range(batch, index, count)
        else:
            assert process_local_range(batch, index, count) == \
                jax_range(batch, index, count)
    # one process, no group: the whole batch
    assert process_local_range(batch) == jax_range(batch) == (0, batch)


def _mesh(rank, size):
    """A DataMesh of ``size`` ranks as ``rank`` sees it, for what needs
    no collective (its rows)."""
    mesh = object.__new__(DataMesh)
    mesh.rank, mesh.size = rank, size
    return mesh


class FlipDataset:
    """``load_raw`` pairs (uint8 image, labelmap) with the COCO labels
    and 'randomcrop+flip': the loader normalises, one-hots and flips on
    the device. Counts its decodes."""
    augmentation = 'randomcrop+flip'
    labels = [1, 2, 3]

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)
        self.maps = rng.integers(1, 4, (n, 16, 16)).astype(np.int64)
        self.decoded = []

    def __len__(self):
        return len(self.images)

    def load_raw(self, index):
        self.decoded.append(index)
        return self.images[index], self.maps[index]


def _epochs(loader, n):
    return [[(x.clone(), y.clone()) for x, y in loader] for _ in range(n)]


def _loaders(n, resume=False, **kwargs):
    """One process's loader and two ranks' on the same dataset; with
    ``resume`` each is set to epoch 3 with its first batch left out."""
    loaders = [DataLoader(FlipDataset(n), batch_size=8, num_workers=0,
                          seed=4, **slicing)
               for slicing in ({}, dict(process_index=0, process_count=2),
                               dict(process_index=1, process_count=2))]
    if resume:
        for loader in loaders:
            loader.fast_forward(2)
            loader.skip_next(1)
    return loaders


@pytest.mark.parametrize('resume', [False, True],
                         ids=['two-epochs', 'resumed'])
def test_rank_batches_concatenate_to_one_process(resume):
    """Two ranks with flips on: each decodes exactly half of every batch;
    their batches, concatenated, are one process's bit for bit, over two
    epochs, and after a resume's fast_forward / skip_next."""
    one, *ranks = _loaders(24, resume)
    epochs = 1 if resume else 2
    want = _epochs(one, epochs)
    got = [_epochs(r, epochs) for r in ranks]
    for e in range(epochs):
        assert len(got[0][e]) == len(want[e]) == (2 if resume else 3)
        for b, (x, y) in enumerate(want[e]):
            for i, t in enumerate((x, y)):
                assert torch.equal(torch.cat([got[0][e][b][i],
                                              got[1][e][b][i]]), t)
    n_decoded = len(one.dataset.decoded)
    assert n_decoded == 8 * len(want[0]) * epochs
    for r in ranks:
        assert len(r.dataset.decoded) == n_decoded // 2
    first = [set(r.dataset.decoded[:4]) for r in ranks]
    assert first[0].isdisjoint(first[1]) and \
        sorted(first[0] | first[1]) == sorted(one.dataset.decoded[:8])
    # the flips drew something: without them the first batch differs
    plain = DataLoader(FlipDataset(24), batch_size=8, num_workers=0, seed=4)
    plain.dataset.augmentation = 'randomcrop'
    if resume:
        plain.fast_forward(2)
        plain.skip_next(1)
    assert not torch.equal(next(iter(plain))[0], want[0][0][0])


@pytest.mark.parametrize('n,batch,count,kept', [
    (20, 8, 2, True),    # remainder 4 splits over 2 ranks
    (20, 6, 3, False),   # remainder 2 does not split over 3
    (21, 8, 2, False),   # remainder 5 does not split over 2
    (20, 8, None, True)])
def test_remainder_batch_rule_is_the_jax_loaders(n, batch, count, kept,
                                                 capsys):
    """drop_last=False keeps the remainder batch only where it divides
    across the ranks, and drops it with one printed line otherwise
    (JAX ``data/loader.py:197-253``): the lengths equal the JAX
    loader's."""
    from patchgan_tpu.data.loader import DataLoader as JaxLoader
    from patchgan_tpu.parallel.mesh import default_mesh
    slicing = {} if count is None else dict(process_index=0,
                                            process_count=count)
    ds = FlipDataset(n)
    loader = DataLoader(ds, batch_size=batch, drop_last=False,
                        num_workers=0, **slicing)
    jax_loader = JaxLoader(ds, batch_size=batch, drop_last=False,
                           num_workers=0, **slicing, mesh=default_mesh(
                               jax.devices()[:1]) if count else None)
    full = n // batch
    assert len(loader) == len(jax_loader) == full + kept
    sizes = [len(x) for _ in range(2) for x, _ in loader]
    per = batch // (count or 1)
    assert sizes == ([per] * full + ([(n % batch) // (count or 1)]
                                     if kept else [])) * 2
    out = capsys.readouterr().out
    assert out.count('dropping the') == (0 if kept else 1)


def test_dropout_masks_are_drawn_for_the_global_batch():
    """World 2's masks, concatenated, equal world 1's, and each rank's
    generator ends where one process's does."""
    x = torch.ones(8, 5, 6, 6)
    one_gen = torch.Generator().manual_seed(11)
    want = dropout(x, one_gen)
    parts = []
    for rank in range(2):
        gen = torch.Generator().manual_seed(11)
        mesh = _mesh(rank, 2)
        parts.append(dropout(mesh.local_rows(x), gen, mesh))
        assert torch.equal(gen.get_state(), one_gen.get_state())
    assert torch.equal(torch.cat(parts), want)
    assert 0.1 < float((want == 0).float().mean()) < 0.3


@pytest.mark.parametrize('capturing', [False, True])
def test_captured_collectives_take_their_own_communicator(monkeypatch,
                                                          capturing):
    """Under NCCL a collective that a capture records goes through
    ``graph_group``, every eager one (and ``barrier`` and
    ``check_replicated`` always) through the group's: no communicator
    takes an eager collective after a replay."""
    import torch.distributed as dist
    mesh = _mesh(0, 1)
    mesh.group, mesh.graph_group = 'group', 'graph group'
    mesh.backend, mesh.device = 'nccl', torch.device('cpu')
    used = []
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: capturing)
    monkeypatch.setattr(dist, 'all_reduce',
                        lambda t, group=None: used.append(group))
    monkeypatch.setattr(dist, 'broadcast',
                        lambda t, src, group=None: used.append(group))
    monkeypatch.setattr(dist, 'barrier',
                        lambda group=None, **kw: used.append(group))
    x = torch.ones(3)
    mesh.mean(x.mean())
    mesh.stat(x)
    mesh.sum_([x, x.clone()])
    want = 'graph group' if capturing else 'group'
    assert used == [want] * 3
    mesh.check_replicated([x], 'weights')
    mesh.barrier()
    assert used[3:] == ['group', 'group']


def test_shutdown_frees_the_captured_graphs_before_the_group():
    """NCCL's teardown waits for every graph that holds a communicator's
    work: ``shutdown`` resets the graphs of each captured step made over
    the mesh, then destroys the group; a step released captures anew."""
    import torch.distributed as dist

    from patchgan_tpu_torch.parallel import mesh as mesh_mod
    from patchgan_tpu_torch.train.graph import CapturedStep
    events = []

    class Graph:
        def reset(self):
            events.append('reset')

    mesh = _mesh(0, 2)
    mesh.device, mesh._captured = torch.device('cpu'), weakref.WeakSet()
    step = CapturedStep(None, None, lambda: (0, 0), lambda: [])
    step._cuda_graphs = [Graph(), Graph()]
    step._graphs, step._eager = {'key': None}, {'key': 1}
    mesh.hold(step)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, 'is_initialized', lambda: True)
        mp.setattr(dist, 'destroy_process_group',
                   lambda: events.append('destroy'))
        mesh_mod.shutdown(mesh)
    assert events == ['reset', 'reset', 'destroy']
    assert (step._cuda_graphs, step._graphs, step._eager) == ([], {}, {})


# the data-parallel step on two gloo ranks


@pytest.fixture(scope='module')
def dp_runs(tmp_path_factory):
    """(the ranks' results, the JAX DP step's (losses, G, D)): the ranks
    run every case of ``CASES``, the JAX case on the JAX package's
    initial weights and batch, and the loss trap; the JAX package runs
    ``tests/test_distributed.py``'s set-up (dropout off) on its default
    8-device mesh."""
    from patchgan_tpu.models import Discriminator, UNet
    from patchgan_tpu.parallel.mesh import default_mesh, replicate, \
        shard_batch
    from patchgan_tpu.train.steps import (init_train_state, make_optimizer,
                                          make_train_step)
    from patchgan_tpu_torch.utils.transfer import state_dict_from_jax
    out = tmp_path_factory.mktemp('dp')
    gen = UNet(input_nc=3, output_nc=1, nf=4, final_act='sigmoid',
               use_pallas=False)
    disc = Discriminator(input_nc=4, ndf=4, n_layers=2, use_pallas=False)
    gtx, dtx = make_optimizer(1e-3), make_optimizer(1e-3)
    state = init_train_state(gen, disc, (1, 128, 128, 3), 1, gtx, dtx,
                             seed=0)
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(8, 128, 128, 3)).astype(np.float32)
    y = (rng.uniform(size=(8, 128, 128, 1)) > 0.5).astype(np.float32)
    weights = (state_dict_from_jax(jax.device_get(state.g_params)),
               state_dict_from_jax(jax.device_get(state.d_params)))
    torch.save((weights, torch_parity.nchw(x), torch_parity.nchw(y)),
               out / 'jax_weights.pt')
    dpw.launch(dpw.step_cases, 2, out, sorted(dpw.CASES),
               str(out / 'jax_weights.pt'))
    ranks = [torch.load(out / f'steps_{r}.pt', weights_only=False)
             for r in range(2)]
    mesh = default_mesh()
    assert mesh.devices.size == 8
    new, losses = jax.jit(make_train_step(gen, disc, gtx, dtx))(
        replicate(state, mesh), *shard_batch((x, y), mesh))
    jax_out = ({k: float(v) for k, v in losses.items()},
               state_dict_from_jax(jax.device_get(new.g_params)),
               state_dict_from_jax(jax.device_get(new.d_params)))
    return ranks, jax_out


def _assert_states_close(want, got, what):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=5e-3, atol=2e-4,
                                   err_msg=f'{what} {k}')


@pytest.mark.parametrize('name', sorted(dpw.CASES))
def test_dp_step_matches_one_process(dp_runs, name):
    """Two ranks on half the global batch each, dropout on: bit-equal to
    each other; the summed gradients of the first update within 1e-4 of
    each tensor's max |g| of one process's on the concatenated batch, and
    losses (each step's and the eval step's, IoU included) and
    parameters within the JAX DP test's limits of it."""
    ranks, _ = dp_runs
    r0, r1 = ranks[0][name], ranks[1][name]
    assert r0[0] == r1[0] and r0[1] == r1[1]
    for a, b in zip(r0[2:4], r1[2:4]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    losses, ev, g, d, grads = dpw.run_case(dpw.CASES[name])
    # the first update's gradients: the ranks' sum against one process's,
    # within 1e-4 of each tensor's largest (fp32, another summation order)
    for got, want in zip(r0[4], grads):
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-4 * float(b.abs().max()))
    for i, (want, got) in enumerate(zip(losses + [ev], r0[0] + [r0[1]])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4,
                                       atol=1e-5, err_msg=f'{k} at {i}')
    _assert_states_close(g, r0[2], 'generator')
    _assert_states_close(d, r0[3], 'discriminator')
    if dpw.CASES[name].get('freeze'):
        init = dpw.build(dpw.CASES[name])[0].state_dict()
        assert all(torch.equal(r0[2][k], init[k]) for k in init
                   if k.startswith('encoder.'))


def test_dp_step_matches_the_jax_dp_step(dp_runs):
    """The port's two gloo ranks against the JAX package's step on its
    8-device mesh, from the same weights and batch, dropout off: the
    port's standing step limits (losses rtol 2e-3 / atol 2e-4,
    parameters within Adam's step-1 sign-flip bound)."""
    ranks, (jax_losses, jax_g, jax_d) = dp_runs
    losses, g, d = ranks[0]['jax']
    assert losses == ranks[1]['jax'][0]
    torch_parity.assert_losses_close([jax_losses], [losses])
    torch_parity.assert_params_close(jax_g, g)
    torch_parity.assert_params_close(jax_d, d)


def test_global_statistics_avoid_the_loss_trap(dp_runs):
    """fc_tversky's gamma applies after the batch mean, so the loss is
    not linear in the batch: with the mean taken over the ranks, each
    rank reports the one-process loss and holds its rows of the
    one-process gradient; the mean of the ranks' own losses is another
    number, and their gradients others, on a batch whose halves
    differ."""
    from patchgan_tpu_torch.ops.losses import fc_tversky
    ranks, _ = dp_runs
    y, p = dpw.trap_batch()
    p = p.clone().requires_grad_(True)
    loss = fc_tversky(y, p, beta=0.75, gamma=0.75)
    grad, = torch.autograd.grad(loss, p)
    loss = float(loss.detach())
    got = [r['trap'] for r in ranks]
    for r in got:
        np.testing.assert_allclose(r['global'][0], loss, rtol=1e-6)
    torch.testing.assert_close(
        torch.cat([r['global'][1] for r in got]), grad, rtol=1e-5,
        atol=1e-12)
    local_mean = np.mean([r['local'][0] for r in got])
    assert abs(local_mean - loss) > 1e-3 * loss
    # a rank's own loss differentiates with its own mean: rescaled to
    # the global batch (1 / ranks), still not the global gradient
    local_grad = torch.cat([r['local'][1] for r in got]) / 2
    assert not torch.allclose(local_grad, grad, rtol=1e-2)
