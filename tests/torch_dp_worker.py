"""Ranks of the port's data-parallel tests on the CPU.

``launch(target, world, *args)`` starts ``world`` processes with the
``spawn`` method, each joining a gloo group on a free port and calling
``target(mesh, *args)`` with its ``DataMesh``; every join has a timeout,
so a hang fails the test instead of stalling the suite. A rank writes
its results with ``torch.save`` into a folder the test reads, and its
traceback there when it fails. This module imports only torch and the
port, so a rank starts without JAX.

The cases: nf=4 / ndf=4 models at 128 px, global batch 8, fp32, built
from fixed seeds (``build``), and seeded global batches
(``global_batches``): every rank makes the whole batch and steps on its
rows.
"""

import os
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

SIZE, NF, BATCH, LR = 128, 4, 8, 1e-3
JOIN_S = 150   # a rank that has not ended by then has hung


def free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(target, rank, world, port, outdir, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                                rank=rank, world_size=world)
        from patchgan_tpu_torch.parallel import DataMesh
        target(DataMesh('cpu'), outdir, *args)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(outdir, f'error_{rank}.txt'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def launch(target, world, outdir, *args, timeout=JOIN_S, main=_rank_main):
    """Run ``target(mesh, outdir, *args)`` on ``world`` gloo ranks;
    ``main(target, rank, world, port, outdir, args)`` starts each (the
    group and the mesh)."""
    import multiprocessing
    ctx = multiprocessing.get_context('spawn')
    port = free_port()
    procs = [ctx.Process(target=main,
                         args=(target, rank, world, port, str(outdir), args))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = ''.join(open(os.path.join(outdir, f'error_{i}.txt')).read()
                     for i in range(world)
                     if os.path.exists(os.path.join(outdir,
                                                    f'error_{i}.txt')))
    if hung:
        raise TimeoutError(f'ranks {hung} did not end in {timeout} s\n'
                           f'{errors}')
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f'rank exit codes {codes}\n{errors}')


# the DP step's cases: loss settings, form, classes, freeze, accumulation
CASES = {
    'tversky-plain': dict(loss_type='tversky'),
    'tversky-s2d': dict(loss_type='tversky', s2d=True),
    'wbce-complement-plain': dict(loss_type='weighted_bce',
                                  bce_weighting='complement'),
    'wbce-complement-s2d': dict(loss_type='weighted_bce',
                                bce_weighting='complement', s2d=True),
    'wbce-inverse-plain': dict(loss_type='weighted_bce',
                               bce_weighting='inverse'),
    'wbce-inverse-s2d': dict(loss_type='weighted_bce',
                             bce_weighting='inverse', s2d=True),
    'mae-plain': dict(loss_type='MAE'),
    'mae-s2d': dict(loss_type='MAE', s2d=True),
    'frozen-accumulate-plain': dict(loss_type='tversky', freeze=('enc',),
                                    every_k=2, steps=4),
    'frozen-accumulate-s2d': dict(loss_type='tversky', freeze=('enc',),
                                  every_k=2, steps=4, s2d=True),
}
OUT_C = 3


def first_grads(opt):
    """The gradients ``opt`` is handed at its first update (after the
    all-reduce of a data-parallel step), kept on the host: Adam's first
    steps are about lr * sign(g), so its weights alone would not show a
    gradient off by a constant factor."""
    kept, update = [], opt.update

    def record(grads):
        if not kept:
            kept.extend(g.detach().clone() for g in grads)
        return update(grads)

    opt.update = record
    return kept


def build(case, mesh=None, weights=None):
    """(generator, discriminator, train step, eval step, the gradients of
    G's and D's first updates) of a case: three classes, tanh, softmax
    head, dropout on; the same weights on every rank (fixed seeds, or
    ``weights``' state_dicts)."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train.steps import (make_eval_step,
                                                make_optimizer,
                                                make_train_step,
                                                trainable_params)
    out_c = case.get('out_c', OUT_C)
    gen = UNet(3, out_c, nf=NF, use_dropout=case.get('dropout', True),
               final_act='softmax' if out_c > 1 else 'sigmoid',
               generator=torch.Generator().manual_seed(1))
    disc = Discriminator(3 + out_c, ndf=NF, n_layers=case.get('n_layers', 3),
                         generator=torch.Generator().manual_seed(2))
    if weights is not None:
        gen.load_state_dict(weights[0])
        disc.load_state_dict(weights[1])
    gen.dropout_generator = torch.Generator().manual_seed(3)
    every_k = case.get('every_k', 1)
    gen_opt = make_optimizer(trainable_params(gen, case.get('freeze', ())),
                             LR, every_k=every_k)
    disc_opt = make_optimizer(disc.parameters(), LR, every_k=every_k)
    grads = [first_grads(o) for o in (gen_opt, disc_opt)]
    kwargs = dict(loss_type=case['loss_type'], seg_alpha=200.0,
                  bce_weighting=case.get('bce_weighting', 'complement'),
                  s2d=case.get('s2d', False), mesh=mesh)
    return (gen, disc, make_train_step(gen, disc, gen_opt, disc_opt,
                                       **kwargs),
            make_eval_step(gen, disc, compute_iou=True, **kwargs), grads)


def global_batches(n_steps, out_c=OUT_C, seed=0):
    """NCHW (x, y) global batches; y one-hot with class shares that
    differ between the batch's halves, so per-half statistics differ."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        x = rng.uniform(size=(BATCH, 3, SIZE, SIZE)).astype(np.float32)
        p = np.array([0.6, 0.3, 0.1] if out_c == 3 else [0.5, 0.5])
        labels = np.concatenate([
            rng.choice(len(p), (BATCH // 2, SIZE, SIZE), p=p),
            rng.choice(len(p), (BATCH // 2, SIZE, SIZE), p=p[::-1])])
        y = np.eye(len(p))[labels].transpose(0, 3, 1, 2)
        if out_c == 1:
            y = y[:, 1:]
        out.append((torch.from_numpy(x), torch.from_numpy(
            np.ascontiguousarray(y, dtype=np.float32))))
    return out


def run_case(case, mesh=None, weights=None):
    """Step a case ``steps`` times (2 by default) on the global batches
    (this rank's rows with a mesh), then evaluate the last batch.
    Returns (losses of each step, eval losses, G state, D state, the
    first updates' gradients)."""
    gen, disc, step, evaluate, grads = build(case, mesh, weights)
    losses = []
    batches = global_batches(case.get('steps', 2), case.get('out_c', OUT_C))
    for x, y in batches:
        if mesh is not None:
            x, y = mesh.local_rows((x, y))
        losses.append({k: float(v) for k, v in step(x, y).items()})
    x, y = batches[-1] if mesh is None else mesh.local_rows(batches[-1])
    ev = {k: float(v) for k, v in evaluate(x, y).items()}
    return (losses, ev, {k: v.clone() for k, v in gen.state_dict().items()},
            {k: v.clone() for k, v in disc.state_dict().items()}, grads)


def step_cases(mesh, outdir, names, jax_weights=None):
    """Each named case of ``CASES`` on this rank, then the JAX case (the
    JAX package's weights and batch, one class, n_layers 2, dropout off)
    and the loss trap; results into ``outdir/steps_<rank>.pt``."""
    out = {name: run_case(CASES[name], mesh) for name in names}
    if jax_weights is not None:
        weights, x, y = torch.load(jax_weights, weights_only=True)
        case = dict(loss_type='tversky', out_c=1, n_layers=2, dropout=False)
        gen, disc, step, _, _ = build(case, mesh, weights)
        losses = step(*mesh.local_rows((x, y)))
        out['jax'] = ({k: float(v) for k, v in losses.items()},
                      {k: v.clone() for k, v in gen.state_dict().items()},
                      {k: v.clone() for k, v in disc.state_dict().items()})
    out['trap'] = tversky_trap(mesh)
    torch.save(out, os.path.join(outdir, f'steps_{mesh.rank}.pt'))


def trap_batch():
    """(y_true, y_pred) whose halves differ: the first half's predictions
    far off, the second's close."""
    rng = np.random.default_rng(5)
    y = (rng.uniform(size=(BATCH, 1, 32, 32)) > 0.5).astype(np.float32)
    noise = rng.uniform(size=y.shape).astype(np.float32)
    p = np.where(np.arange(BATCH)[:, None, None, None] < BATCH // 2,
                 noise, 0.9 * y + 0.1 * noise)
    return torch.from_numpy(y), torch.from_numpy(p.astype(np.float32))


def tversky_trap(mesh):
    """On this rank's rows: the fc_tversky loss with the global mean
    (``mesh``) and without (the rank's own batch), each with its
    gradient with respect to the predictions."""
    from patchgan_tpu_torch.ops.losses import fc_tversky
    y, p = mesh.local_rows(trap_batch())
    out = {}
    for name, m in (('global', mesh), ('local', None)):
        q = p.clone().requires_grad_(True)
        loss = fc_tversky(y, q, beta=0.75, gamma=0.75, mesh=m)
        out[name] = (loss.detach().item(), torch.autograd.grad(loss, q)[0])
    return out


# the Trainer under two ranks


class ArrayDataset:
    """Seeded ``load_raw`` pairs (uint8 image, labelmap of the labels 1-3)
    with 'randomcrop+flip': the loader's own normalise, one-hot and
    flips on the device."""
    augmentation = 'randomcrop+flip'
    labels = [1, 2, 3]

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, SIZE, SIZE, 3), np.uint8)
        self.maps = rng.integers(1, 4, (n, SIZE, SIZE)).astype(np.int64)

    def __len__(self):
        return len(self.images)

    def load_raw(self, index):
        return self.images[index], self.maps[index]


class Interrupted(Exception):
    pass


class Interrupting:
    """A loader that stops the run (as a kill would) when it is asked for
    batch ``at[1]`` (0-based) of iteration ``at[0]``; the rest is the
    wrapped loader's."""

    def __init__(self, loader, at):
        self.loader, self.at = loader, at

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if (self.loader.epoch, i) == self.at:
                raise Interrupted
            yield batch


def trainer(mesh, folder):
    from patchgan_tpu_torch.data import DataLoader
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train import Trainer
    gen = UNet(3, OUT_C, nf=NF, use_dropout=True,
               generator=torch.Generator().manual_seed(1))
    disc = Discriminator(3 + OUT_C, ndf=NF, n_layers=3,
                         generator=torch.Generator().manual_seed(2))
    t = Trainer(gen, disc, folder, device='cpu', seed=3, mesh=mesh)
    t.save_every_steps = 1
    t.compute_iou = True
    rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    slicing = dict(process_index=rank, process_count=size,
                   batch_size=BATCH, num_workers=0, seed=0)
    return t, (DataLoader(ArrayDataset(2 * BATCH, 0), **slicing),
               DataLoader(ArrayDataset(BATCH + 4, 1), drop_last=False,
                          **slicing))


TRAIN = dict(epochs=2, reduce_on_plateau=True, save_freq=1)


def trainer_runs(mesh, outdir):
    """An uninterrupted two-epoch run into ``outdir/whole``, and one
    stopped at epoch 2's second batch and resumed from its rolling state
    into ``outdir/cut``; counts each rank's writes."""
    from patchgan_tpu_torch.train import trainer as trainer_module
    writes = []
    save = trainer_module.ckpt.save_state_dict
    trainer_module.ckpt.save_state_dict = \
        lambda path, sd: (writes.append(path), save(path, sd))
    out = {}
    t, (train, val) = trainer(mesh, os.path.join(outdir, 'whole'))
    out['history'] = t.train(train, val, **TRAIN)
    out['lr'] = (t.gen_opt.lr, t.disc_opt.lr)
    out['schedules'] = [dict(vars(s)) for s in t._scheds]
    t, (train, val) = trainer(mesh, os.path.join(outdir, 'cut'))
    try:
        t.train(Interrupting(train, (2, 1)), val, **TRAIN)
    except Interrupted:
        pass
    t, (train, val) = trainer(mesh, os.path.join(outdir, 'cut'))
    t.load_last_checkpoint()
    out['resumed_at'] = (t.start, t._resume_skip_batches)
    t.train(train, val, **TRAIN)
    out['writes'] = writes
    torch.save(out, os.path.join(outdir, f'trainer_{mesh.rank}.pt'))


# the async exact-resume store (checkpoint_format 'orbax') under two ranks


def dcp_trainer(mesh, folder):
    """``trainer`` writing its exact-resume state through the async store
    at every epoch and every batch."""
    t, loaders = trainer(mesh, folder)
    t.checkpoint_format, t.save_optimizer_state = 'orbax', True
    return t, loaders


def host_state(t):
    """The Trainer's ``training_state()`` with every tensor copied to the
    host."""
    def copy(tree):
        if torch.is_tensor(tree):
            return tree.detach().cpu().clone()
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [copy(v) for v in tree]
        return tree
    return copy(t.training_state())


def single_dcp_run(folder):
    """One process: epoch 1 of ``dcp_trainer`` on the whole global
    batches; its state after the epoch."""
    t, (train, val) = dcp_trainer(None, folder)
    t.train(train, val, **dict(TRAIN, epochs=1))
    return host_state(t)


def restored_state(mesh, folder):
    """A fresh ``dcp_trainer`` that resumes ``folder`` and restores its
    exact-resume state (a ``train()`` with no epoch left to run)."""
    t, (train, val) = dcp_trainer(mesh, folder)
    t.load_last_checkpoint()
    t.train(train, val, **dict(TRAIN, epochs=t.start - 1))
    return host_state(t)


def dcp_trainer_runs(mesh, outdir):
    """With the async store: an uninterrupted two-epoch run into
    ``outdir/whole`` and one stopped at epoch 2's second batch and
    resumed from its rolling state into ``outdir/cut``, counting each
    rank's writes; then every rank restores ``outdir/single``, a
    one-process run's epoch-1 state."""
    from patchgan_tpu_torch.train import trainer as trainer_module
    writes = []
    save_npz = trainer_module.ckpt.save_state_dict
    save_dcp = trainer_module.orbax_ckpt.save_async
    trainer_module.ckpt.save_state_dict = \
        lambda path, sd: (writes.append(path), save_npz(path, sd))
    trainer_module.orbax_ckpt.save_async = \
        lambda path, state: (writes.append(path), save_dcp(path, state))
    out = {}
    t, (train, val) = dcp_trainer(mesh, os.path.join(outdir, 'whole'))
    out['history'] = t.train(train, val, **TRAIN)
    out['state'] = host_state(t)
    t, (train, val) = dcp_trainer(mesh, os.path.join(outdir, 'cut'))
    try:
        t.train(Interrupting(train, (2, 1)), val, **TRAIN)
    except Interrupted:
        pass
    t, (train, val) = dcp_trainer(mesh, os.path.join(outdir, 'cut'))
    t.load_last_checkpoint()
    out['resumed_at'] = (t.start, t._resume_skip_batches)
    out['resumed_from'] = os.path.basename(t._pending_training_state)
    t.train(train, val, **TRAIN)
    out['cut_state'] = host_state(t)
    out['writes'] = writes
    out['restored'] = restored_state(mesh, os.path.join(outdir, 'single'))
    torch.save(out, os.path.join(outdir, f'dcp_{mesh.rank}.pt'))
