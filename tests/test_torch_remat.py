"""``UNet(remat=...)``: the blocks' conv + norm + activation recomputed in
the backward (``models/blocks.py``; JAX ``models/unet.py:53-62``). In
fp32 on the CPU the recompute gives the same bits, so ``remat`` True or a
tuple of block names leaves every step's losses, the gradients the
optimizers take and the updated parameters bit-equal to ``remat=False``:
in the plain and the s2d form, full and frozen + accumulating, and on a
(1, 2) grid of gloo ranks (dp x tp, the model group's gathers outside the
checkpoint). The port's ``remat=True`` step holds against the JAX
package's ``UNet(remat=True)`` step within the G+D step limits; the band
path refuses ``remat``; an evaluation forward runs no checkpoint."""

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker as dpw
import torch_parity
import torch_tp_worker as tpw

torch.set_num_threads(2)

STEPS = 3
REMAT = [True, ('enc0', 'dec0', 'dec6'), ('enc3', 'dec2', 'nowhere')]
FORMS = {
    'plain': dict(),
    's2d': dict(s2d=True),
    'plain-frozen-accumulate': dict(freeze=('enc',), every_k=2),
    's2d-frozen-accumulate': dict(s2d=True, freeze=('enc',), every_k=2),
}


def _run(form, remat):
    """STEPS steps of the port's G+D step (three classes, relu, softmax
    head, dropout on, nf=4, 128 px, batch 2): (each step's losses, the
    gradients of G's and D's first updates, G's and D's state)."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train.steps import (make_optimizer,
                                                make_train_step,
                                                trainable_params)
    gen = UNet(3, 3, nf=4, use_dropout=True, activation='relu',
               generator=torch.Generator().manual_seed(1), remat=remat)
    disc = Discriminator(6, ndf=4, n_layers=3,
                         generator=torch.Generator().manual_seed(2))
    gen.dropout_generator = torch.Generator().manual_seed(3)
    every_k = form.get('every_k', 1)
    opts = (make_optimizer(trainable_params(gen, form.get('freeze', ())),
                           1e-3, every_k=every_k),
            make_optimizer(disc.parameters(), 1e-3, every_k=every_k))
    grads = [dpw.first_grads(o) for o in opts]
    step = make_train_step(gen, disc, *opts, s2d=form.get('s2d', False))
    losses = []
    for x, y in torch_parity.batches(128, 3, STEPS, seed=5):
        losses.append({k: v.item() for k, v in step(
            torch_parity.nchw(x), torch_parity.nchw(y)).items()})
    return losses, grads, gen.state_dict(), disc.state_dict()


def _assert_bit_equal(want, got):
    losses, grads, g, d = want
    assert got[0] == losses
    for a, b in zip(got[1], grads):
        assert len(a) == len(b) and all(torch.equal(u, v)
                                        for u, v in zip(a, b))
    for want_sd, got_sd in ((g, got[2]), (d, got[3])):
        assert set(want_sd) == set(got_sd)
        for k in want_sd:
            assert torch.equal(want_sd[k], got_sd[k]), k


@pytest.fixture(scope='module')
def plain_runs():
    return {name: _run(form, False) for name, form in FORMS.items()}


@pytest.mark.parametrize('remat', REMAT, ids=['all', 'ends', 'some'])
@pytest.mark.parametrize('name', sorted(FORMS))
def test_remat_step_is_bit_equal(plain_runs, name, remat):
    _assert_bit_equal(plain_runs[name], _run(FORMS[name], remat))


def test_blocks_take_their_remat():
    from patchgan_tpu_torch.models import UNet
    gen = UNet(3, 1, nf=4, remat=('enc0', 'enc5', 'dec6', 'dec9'))
    assert [b.remat for b in gen.encoder] == [True] + [False] * 4 + \
        [True, False]
    assert [b.remat for b in gen.decoder] == [False] * 6 + [True]
    assert all(b.remat for b in UNet(3, 1, nf=4, remat=True).encoder)
    assert not any(b.remat for b in UNet(3, 1, nf=4).decoder)


def test_forward_without_grad_runs_no_checkpoint(monkeypatch):
    """Under ``no_grad`` (the eval step, the engine) the core runs as it
    is; while autograd records, each remat block enters one checkpoint."""
    from patchgan_tpu_torch.models import UNet, blocks
    calls = []
    real = blocks.checkpoint

    def counting(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(blocks, 'checkpoint', counting)
    gen = UNet(3, 2, nf=4, remat=True,
               generator=torch.Generator().manual_seed(1))
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = gen(x)
    assert calls == []
    out = gen(x)
    assert torch.equal(out.detach(), ref)
    assert len(calls) == 14
    assert all(c == {'use_reentrant': False, 'preserve_rng_state': False}
               for c in calls)


def test_band_path_refuses_remat():
    from patchgan_tpu_torch.models import UNet
    from patchgan_tpu_torch.parallel.spatial import SpatialMesh

    class Axis:
        size = 2
    mesh = object.__new__(SpatialMesh)
    mesh.spatial = Axis()
    gen = UNet(3, 1, nf=4, remat=('dec1',))
    x = torch.zeros(1, 3, 128, 256)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        gen(x, mesh=mesh)


# against the JAX package


def test_remat_step_matches_jax_remat_step():
    """The JAX package's ``UNet(remat=True)`` step and the port's, from
    the JAX package's weights (relu, one class, sigmoid head, dropout
    off, nf=4, 128 px): each step's losses within rtol 2e-3 / atol 2e-4,
    the parameters after the first step within Adam's sign-flip bound."""
    from patchgan_tpu.models import Discriminator as JaxDisc
    from patchgan_tpu.models import UNet as JaxUNet
    from patchgan_tpu.train.steps import (init_train_state, make_optimizer,
                                          make_train_step)
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train import steps
    from patchgan_tpu_torch.utils.transfer import state_dict_from_jax
    jgen = JaxUNet(input_nc=3, output_nc=1, nf=4, activation='relu',
                   final_act='sigmoid', use_pallas=False, remat=True)
    jdisc = JaxDisc(input_nc=4, ndf=4, n_layers=3, use_pallas=False)
    gtx, dtx = make_optimizer(1e-3), make_optimizer(1e-3)
    state = init_train_state(jgen, jdisc, (1, 128, 128, 3), 1, gtx, dtx,
                             seed=0)
    jstep = jax.jit(make_train_step(jgen, jdisc, gtx, dtx,
                                    loss_type='tversky', seg_alpha=200.0))
    gen = UNet(3, 1, nf=4, activation='relu', final_act='sigmoid',
               remat=True)
    disc = Discriminator(4, ndf=4, n_layers=3)
    gen.load_state_dict(state_dict_from_jax(jax.device_get(state.g_params)))
    disc.load_state_dict(state_dict_from_jax(
        jax.device_get(state.d_params)))
    pstep = steps.make_train_step(
        gen, disc, steps.make_optimizer(gen.parameters(), 1e-3),
        steps.make_optimizer(disc.parameters(), 1e-3), loss_type='tversky',
        seg_alpha=200.0)
    jl, pl = [], []
    for i, (x, y) in enumerate(torch_parity.batches(128, 1, 2)):
        state, losses = jstep(state, x, y)
        jl.append({k: float(v) for k, v in losses.items()})
        pl.append({k: float(v) for k, v in pstep(
            torch_parity.nchw(x), torch_parity.nchw(y)).items()})
        if i == 0:
            torch_parity.assert_params_close(
                state_dict_from_jax(jax.device_get(state.g_params)),
                gen.state_dict())
            torch_parity.assert_params_close(
                state_dict_from_jax(jax.device_get(state.d_params)),
                disc.state_dict())
    torch_parity.assert_losses_close(jl, pl)


# dp x tp on two gloo ranks


@pytest.fixture(scope='module')
def tp_remat(tmp_path_factory):
    out = tmp_path_factory.mktemp('tp_remat')
    tpw.launch(tpw.remat_cases, 1, 2, out, ['plain', 'head4-s2d'])
    return [torch.load(out / f'remat_{r}.pt', weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize('remat', tpw.REMAT[1:], ids=['all', 'ends'])
@pytest.mark.parametrize('name', ['plain', 'head4-s2d'])
def test_remat_hybrid_step_is_bit_equal(tp_remat, name, remat):
    """On each rank of the (1, 2) grid: each step's losses, the gathered
    state and the first updates' gradients equal ``remat=False``'s bit
    for bit (head4: the s2d head sharded, its conv checkpointed and its
    gather and softmax outside)."""
    for rank in tp_remat:
        want, got = rank[(name, False)], rank[(name, remat)]
        assert got[0] == want[0]
        for i in (1, 2):
            assert set(got[i]) == set(want[i])
            assert all(torch.equal(got[i][k], want[i][k]) for k in want[i])
        for a, b in zip(got[3], want[3]):
            assert all(torch.equal(u, v) for u, v in zip(a, b))
