"""Ranks of the port's data x model parallel tests on the CPU.

``launch(target, dp, tp, outdir, *args)`` starts dp * tp processes (the
``spawn`` method, a gloo group on a free port, every join with a timeout:
``torch_dp_worker.launch``), each calling ``target(mesh, outdir, *args)``
with its ``HybridMesh``; ``launch_aot`` starts ranks that see torchrun's
environment and run ``patchgan_aot``. A rank writes its results with
``torch.save`` into a folder the test reads. This module imports only
torch and the port, so a rank starts without JAX.

The cases: nf=4 / ndf=4 models at 128 px, global batch 8, fp32, dropout
on, from fixed seeds: three classes (the softmax head replicated at tp 2,
as 3 does not divide it) and four (the head sharded), in both forms.
"""

import contextlib
import io
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

import torch_dp_worker as dpw

CASES = {
    'plain': dict(),
    's2d': dict(s2d=True),
    'head4-plain': dict(out_c=4),
    'head4-s2d': dict(out_c=4, s2d=True),
}
STEPS = 2
# the JAX package's hybrid test (tests/test_distributed.py): one class,
# n_layers 2, dropout off, one step
JAX_CASE = dict(out_c=1, n_layers=2, dropout=False)


def _rank_main(target, rank, world, port, outdir, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                                rank=rank, world_size=world)
        from patchgan_tpu_torch.parallel import hybrid_mesh
        dp, tp, *rest = args
        target(hybrid_mesh(dp, tp, 'cpu'), outdir, *rest)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(outdir, f'error_{rank}.txt'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def launch(target, dp, tp, outdir, *args):
    """Run ``target(mesh, outdir, *args)`` on a (dp, tp) grid of gloo
    ranks."""
    dpw.launch(target, dp * tp, outdir, dp, tp, *args, main=_rank_main)


def build(case, mesh=None, weights=None):
    """(generator, discriminator, their optimizers, the train step, the
    first update's gradients of G and D) of a case, the state placed on
    ``mesh`` when there is one; the same weights on every rank (fixed
    seeds, or ``weights``' state_dicts)."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.parallel import place_hybrid_state
    from patchgan_tpu_torch.train.steps import make_optimizer, \
        make_train_step
    out_c = case.get('out_c', dpw.OUT_C)
    gen = UNet(3, out_c, nf=dpw.NF, use_dropout=case.get('dropout', True),
               final_act='softmax' if out_c > 1 else 'sigmoid',
               generator=torch.Generator().manual_seed(1),
               remat=case.get('remat', False))
    disc = Discriminator(3 + out_c, ndf=dpw.NF,
                         n_layers=case.get('n_layers', 3),
                         generator=torch.Generator().manual_seed(2))
    if weights is not None:
        gen.load_state_dict(weights[0])
        disc.load_state_dict(weights[1])
    gen.dropout_generator = torch.Generator().manual_seed(3)
    opts = [make_optimizer(m.parameters(), dpw.LR) for m in (gen, disc)]
    grads = [dpw.first_grads(o) for o in opts]
    if mesh is not None:
        place_hybrid_state(gen, disc, opts, mesh)
    step = make_train_step(gen, disc, *opts, loss_type='tversky',
                           seg_alpha=200.0, s2d=case.get('s2d', False),
                           mesh=mesh)
    return gen, disc, opts, step, grads


def global_batches(n_steps, out_c, seed=0):
    """NCHW (x, y) global batches of ``out_c`` one-hot classes whose
    shares differ between the batch's halves."""
    rng = np.random.default_rng(seed)
    p = np.arange(out_c, 0, -1) / (out_c * (out_c + 1) / 2)
    size, n = dpw.SIZE, dpw.BATCH
    out = []
    for _ in range(n_steps):
        x = rng.uniform(size=(n, 3, size, size)).astype(np.float32)
        labels = np.concatenate([
            rng.choice(out_c, (n // 2, size, size), p=p),
            rng.choice(out_c, (n // 2, size, size), p=p[::-1])])
        y = np.eye(out_c, dtype=np.float32)[labels].transpose(0, 3, 1, 2)
        out.append((torch.from_numpy(x),
                    torch.from_numpy(np.ascontiguousarray(y))))
    return out


def whole(mesh, module, tensors):
    """The whole tensors one process holds of ``tensors``, one per
    parameter of ``module`` in order (this rank's shards where the
    parameter is sharded)."""
    from patchgan_tpu_torch.parallel import model_parallel_shardings
    dims = model_parallel_shardings(module, mesh.model.size).values()
    return [t.clone() if d is None else mesh.model.unshard(t, d)
            for t, d in zip(tensors, dims)]


def run_case(case, mesh=None, weights=None, batches=None):
    """Step a case on ``batches`` (``STEPS`` seeded global batches by
    default; this rank's rows of its data rank with a mesh). Returns (each
    step's losses, G state, D state, the first update's gradients of G
    and D), all whole."""
    from patchgan_tpu_torch.parallel import gather_hybrid_state
    gen, disc, opts, step, grads = build(case, mesh, weights)
    if batches is None:
        batches = global_batches(STEPS, case.get('out_c', dpw.OUT_C))
    losses = []
    for x, y in batches:
        if mesh is not None:
            x, y = mesh.local_rows((x, y))
        losses.append({k: float(v) for k, v in step(x, y).items()})
    if mesh is None:
        return (losses, gen.state_dict(), disc.state_dict(),
                [list(g) for g in grads])
    mesh.model.check_replicated(replicated(mesh, (gen, disc)),
                                'replicated parameters')
    g, d, _ = gather_hybrid_state(gen, disc, opts, mesh)
    return (losses, g, d, [whole(mesh, m, gs)
                           for m, gs in zip((gen, disc), grads)])


def replicated(mesh, modules):
    """The parameters of ``modules`` that every rank holds whole."""
    from patchgan_tpu_torch.parallel import model_parallel_shardings
    out = []
    for m in modules:
        dims = model_parallel_shardings(m, mesh.model.size)
        out += [p for name, p in m.named_parameters() if dims[name] is None]
    return out


def round_trip(mesh):
    """``place_hybrid_state`` then ``gather_hybrid_state`` on models and
    optimizers with seeded non-zero moments (a bf16 first moment, and a
    ``MultiSteps`` accumulator): True when every tensor comes back bit
    for bit."""
    from patchgan_tpu_torch.parallel import (gather_hybrid_state,
                                             place_hybrid_state)
    from patchgan_tpu_torch.parallel.sharding import optimizer_state
    from patchgan_tpu_torch.train.steps import make_optimizer
    gen, disc, _, _, _ = build(dict(out_c=4))
    opts = [make_optimizer(gen.parameters(), mu_dtype=torch.bfloat16),
            make_optimizer(disc.parameters(), every_k=2)]
    seed = torch.Generator().manual_seed(4)
    for opt in opts:
        inner = getattr(opt, 'inner', opt)
        for t in inner.mu + inner.nu + getattr(opt, 'acc', []):
            t.copy_(torch.rand(t.shape, generator=seed))
    before = ({k: v.clone() for k, v in gen.state_dict().items()},
              {k: v.clone() for k, v in disc.state_dict().items()},
              [[[t.clone() for t in state] for state in
                optimizer_state(o)[1]] for o in opts])
    place_hybrid_state(gen, disc, opts, mesh)
    g, d, states = gather_hybrid_state(gen, disc, opts, mesh)
    after = (g, d, [[states[i][k] for k in ('mu', 'nu', 'acc')
                     if k in states[i]] for i in range(2)])
    same = all(torch.equal(before[i][k], after[i][k]) and
               before[i][k].dtype == after[i][k].dtype
               for i in range(2) for k in before[i])
    for want, got in zip(before[2], after[2]):
        same &= len(want) == len(got) and all(
            torch.equal(a, b) and a.dtype == b.dtype
            for w, g_ in zip(want, got) for a, b in zip(w, g_))
    return same


def step_cases(mesh, outdir, names, jax_weights=None):
    """Each named case of ``CASES`` on this rank, then (with
    ``jax_weights``) the JAX hybrid test's case on the JAX package's
    weights and batch, and the state round trip; results into
    ``outdir/tp_<rank>.pt``."""
    out = {name: run_case(CASES[name], mesh) for name in names}
    if jax_weights is not None:
        weights, x, y = torch.load(jax_weights, weights_only=True)
        out['jax'] = run_case(JAX_CASE, mesh, weights, [(x, y)])
    out['round_trip'] = round_trip(mesh)
    out['grid'] = (mesh.data.rank, mesh.model.rank)
    torch.save(out, os.path.join(outdir, f'tp_{mesh.rank}.pt'))


def _aot_main(target, rank, world, port, outdir, args):
    """A rank as torchrun starts one: its environment, no group yet."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(port))
    try:
        target(rank, outdir, *args)
    except BaseException:
        with open(os.path.join(outdir, f'error_{rank}.txt'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def aot_rank(rank, outdir, argv):
    """``patchgan_aot(argv)`` on this rank: its result and what it
    printed into ``outdir/aot_<rank>.pt``."""
    from patchgan_tpu_torch.cli.aot import patchgan_aot
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        result = patchgan_aot(argv)
    torch.save((result, text.getvalue()),
               os.path.join(outdir, f'aot_{rank}.pt'))


def launch_aot(world, outdir, argv):
    dpw.launch(aot_rank, world, outdir, argv, main=_aot_main)


# UNet(remat=...) on the grid: the sharded levels' cores recomputed in
# the backward, the model group's gathers outside the checkpoint
REMAT = (False, True, ('enc0', 'dec0', 'dec6'))


def remat_cases(mesh, outdir, names):
    """Each named case of ``CASES`` at each of ``REMAT`` on this rank;
    results into ``outdir/remat_<rank>.pt``."""
    out = {(name, remat): run_case(dict(CASES[name], remat=remat), mesh)
           for name in names for remat in REMAT}
    torch.save(out, os.path.join(outdir, f'remat_{mesh.rank}.pt'))
