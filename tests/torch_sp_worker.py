"""Ranks of the port's spatial-parallel tests on the CPU.

``launch(target, dp, sp, outdir, *args)`` starts dp * sp processes (the
``spawn`` method, a gloo group on a free port, every join with a timeout:
``torch_dp_worker.launch``), each calling ``target(mesh, outdir, *args)``
with its ``SpatialMesh``. A rank writes its results with ``torch.save``
into a folder the test reads. This module imports only torch and the
port, so a rank starts without JAX.

The step cases: nf=4 / ndf=4 models at 128 px, global batch 8, fp32, from
fixed seeds (``torch_dp_worker.build``); every rank makes the whole batch
and hands the step its data rank's rows, whole in H (the step keeps its
band).
"""

import contextlib
import os
import traceback

import torch
import torch.distributed as dist
import torch.nn.functional as F

import torch_dp_worker as dpw

# the step against one process: loss settings, dropout off, one step
CASES = {
    'tversky': dict(loss_type='tversky', dropout=False),
    'wbce-complement': dict(loss_type='weighted_bce',
                            bce_weighting='complement', dropout=False),
    'wbce-inverse': dict(loss_type='weighted_bce', bce_weighting='inverse',
                         dropout=False),
    'mae': dict(loss_type='MAE', dropout=False),
}
# dropout on, two steps (the (1, 2) grid)
DROPOUT_CASE = dict(loss_type='tversky', dropout=True)
# the JAX package's spatial test (tests/test_distributed.py:173-211): one
# class, n_layers 2, dropout off, one step
JAX_CASE = dict(loss_type='tversky', out_c=1, n_layers=2, dropout=False)


def _rank_main(target, rank, world, port, outdir, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                                rank=rank, world_size=world)
        from patchgan_tpu_torch.parallel import spatial_mesh
        dp, sp, *rest = args
        target(spatial_mesh(dp, sp, 'cpu'), outdir, *rest)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(outdir, f'error_{rank}.txt'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def launch(target, dp, sp, outdir, *args):
    """Run ``target(mesh, outdir, *args)`` on a (dp, sp) grid of gloo
    ranks."""
    dpw.launch(target, dp * sp, outdir, dp, sp, *args, main=_rank_main)


# the band operations


def _rand(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g)


def _max_err(a, b):
    """max |a - b| over max(1, max |b|): a sum's rounding grows with its
    size."""
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def band_ops(mesh, outdir):
    """On this rank: each band operation and a conv over haloed bands,
    forward and backward, against the same function on the whole tensor
    (every rank knows every rank's upstream gradient, from its seed), in
    fp32. Writes {check: its error (``_max_err``)} into
    ``outdir/ops_<rank>.pt``."""
    axis = mesh.spatial
    sp, s = axis.size, axis.rank
    n, c, h, w = 2, 3, 8 * sp, 6
    x = _rand(0, n, c, h, w)
    lo, hi = axis.rows(h)
    out = {}

    # halo(1, 2): the padded rows [lo - 1, hi + 2), and its conjugate
    band = x[:, :, lo:hi].clone().requires_grad_(True)
    got = axis.halo(band, 1, 2)
    pad = F.pad(x, (0, 0, 1, 2))
    out['halo forward'] = _max_err(got, pad[:, :, lo:hi + 3])
    g_of = [_rand(10 + r, n, c, h // sp + 3, w) for r in range(sp)]
    gx, = torch.autograd.grad(got, band, g_of[s])
    xw = x.clone().requires_grad_(True)
    padw = F.pad(xw, (0, 0, 1, 2))
    total = sum((padw[:, :, r * (h // sp):(r + 1) * (h // sp) + 3]
                 * g_of[r]).sum() for r in range(sp))
    want, = torch.autograd.grad(total, xw)
    out['halo backward'] = _max_err(gx, want[:, :, lo:hi])

    # band_sum of per-band partials, and its gradient (passed on)
    band = x[:, :, lo:hi].clone().requires_grad_(True)
    sums = axis.band_sum(band.sum(dim=(2, 3)))
    out['band_sum forward'] = _max_err(sums, x.sum(dim=(2, 3)))
    coef = _rand(20, n, c)
    gx, = torch.autograd.grad((sums * coef).sum(), band)
    out['band_sum backward'] = _max_err(gx, coef[..., None, None]
                                        .expand_as(gx))

    # gather_band and split_band, with their conjugates
    band = x[:, :, lo:hi].clone().requires_grad_(True)
    whole = axis.gather_band(band)
    out['gather_band forward'] = _max_err(whole, x)
    g_of = [_rand(30 + r, n, c, h, w) for r in range(sp)]
    gx, = torch.autograd.grad(whole, band, g_of[s])
    out['gather_band backward'] = _max_err(gx, sum(g_of)[:, :, lo:hi])
    xw = x.clone().requires_grad_(True)
    part = axis.split_band(xw)
    out['split_band forward'] = _max_err(part, x[:, :, lo:hi])
    g_band = _rand(40 + s, n, c, h // sp, w)
    gx, = torch.autograd.grad(part, xw, g_band)
    want = torch.zeros_like(x)
    want[:, :, lo:hi] = g_band
    out['split_band backward'] = _max_err(gx, want)

    # convs over haloed bands: k4/s2/p1, and k4/s1/p1 with the H - 1 rule
    wt = _rand(50, 5, c, 4, 4) * 0.3
    for name, stride, below in (('k4s2', 2, 1), ('k4s1', 1, 2)):
        band = x[:, :, lo:hi].clone().requires_grad_(True)
        wb = wt.clone().requires_grad_(True)
        y = F.conv2d(axis.halo(band, 1, below), wb, stride=stride,
                     padding=(0, 1))
        xw = x.clone().requires_grad_(True)
        ww = wt.clone().requires_grad_(True)
        yw = F.conv2d(xw, ww, stride=stride, padding=1)
        rows = yw.shape[2]
        olo, ohi = lo // stride, min(hi // stride, rows)
        y = y[:, :, :ohi - olo]
        out[f'{name} forward'] = _max_err(y, yw[:, :, olo:ohi])
        g_of = [_rand(60 + r, *yw.shape) for r in range(sp)]
        bounds = [(r * (h // sp) // stride,
                   min((r + 1) * (h // sp) // stride, rows))
                  for r in range(sp)]
        gx, gw = torch.autograd.grad(y, (band, wb),
                                     g_of[s][:, :, olo:ohi])
        total = sum((yw[:, :, a:b] * g_of[r][:, :, a:b]).sum()
                    for r, (a, b) in enumerate(bounds))
        want_x, want_w = torch.autograd.grad(total, (xw, ww))
        out[f'{name} backward x'] = _max_err(gx, want_x[:, :, lo:hi])
        out[f'{name} backward w (summed)'] = _max_err(axis.stat(gw), want_w)

    # shard_batch_spatial: the rank's rows and band; replicate_spatial:
    # rank 0's values on every rank, in place
    from patchgan_tpu_torch.parallel import (replicate_spatial,
                                             shard_batch_spatial)
    xs, = shard_batch_spatial((x,), mesh)
    out['api shard_batch_spatial'] = _max_err(
        xs, mesh.data.local_rows(x)[:, :, lo:hi])
    mine = _rand(90 + mesh.rank, 3, 4)
    replicate_spatial([mine], mesh)
    out['api replicate_spatial'] = _max_err(mine, _rand(90, 3, 4))

    out.update(disc_checks(mesh))
    torch.save(out, os.path.join(outdir, f'ops_{mesh.rank}.pt'))


def disc_checks(mesh):
    """The discriminator's band forward (paired, two masks, norm on) at a
    height whose bands it splits and one where it runs whole, against the
    whole forward's rows: outputs, and after summing over the group the
    weight gradients; the inputs' gradients on the band."""
    from patchgan_tpu_torch.models import Discriminator
    from patchgan_tpu_torch.models.disc import disc_rows, disc_splits
    axis = mesh.spatial
    sp = axis.size
    out = {}
    disc = Discriminator(5, ndf=4, n_layers=3, norm=True,
                         generator=torch.Generator().manual_seed(70))
    for h in (32 * sp, 16 * sp):
        form = 'split' if disc_splits(h, sp, 3) else 'whole'
        x = _rand(71, 2, 3, h, 32)
        ms = (_rand(72, 2, 2, h, 32).sigmoid(), _rand(73, 2, 2, h, 32))
        lo, hi = axis.rows(h)
        band_in = [t[:, :, lo:hi].clone().requires_grad_(True)
                   for t in (x,) + ms]
        got = disc(band_in[0], tuple(band_in[1:]), mesh=mesh)
        whole_in = [t.clone().requires_grad_(True) for t in (x,) + ms]
        want = disc(whole_in[0], tuple(whole_in[1:]))
        olo, ohi, rows = disc_rows(h, sp, axis.rank, 3)
        assert rows == want[0].shape[2]
        out[f'disc {form} forward'] = max(
            _max_err(a, b[:, :, olo:ohi]) for a, b in zip(got, want))
        g_of = [[_rand(80 + 2 * r + k, *want[k].shape) for k in range(2)]
                for r in range(sp)]
        params = list(disc.parameters())
        grads = torch.autograd.grad(
            sum((o * g_of[axis.rank][k][:, :, olo:ohi]).sum()
                for k, o in enumerate(got)), band_in + params)
        total = sum((want[k][:, :, a:b] * g_of[r][k][:, :, a:b]).sum()
                    for r in range(sp) for k in range(2)
                    for a, b, _ in [disc_rows(h, sp, r, 3)])
        wants = torch.autograd.grad(total, whole_in + params)
        out[f'disc {form} backward inputs'] = max(
            _max_err(a, b[:, :, lo:hi]) for a, b in zip(grads[:3], wants[:3]))
        out[f'disc {form} backward w (summed)'] = max(
            _max_err(axis.stat(a), b) for a, b in zip(grads[3:], wants[3:]))
    return out


# the step


def run_case(case, mesh=None, weights=None, batches=None, steps=2):
    """Step a case (``torch_dp_worker.build``; plain form) on ``batches``
    (``steps`` seeded global batches by default; this rank's data rows
    with a mesh), then evaluate the last. Returns (each step's losses, the
    eval losses, G state, D state, the first updates' gradients)."""
    return dpw.run_case(dict(case, steps=steps), mesh, weights) \
        if batches is None else _run_on(case, mesh, weights, batches)


def _run_on(case, mesh, weights, batches):
    gen, disc, step, evaluate, grads = dpw.build(case, mesh, weights)
    losses = []
    for x, y in batches:
        if mesh is not None:
            x, y = mesh.local_rows((x, y))
        losses.append({k: float(v) for k, v in step(x, y).items()})
    x, y = batches[-1] if mesh is None else mesh.local_rows(batches[-1])
    ev = {k: float(v) for k, v in evaluate(x, y).items()}
    return (losses, ev, {k: v.clone() for k, v in gen.state_dict().items()},
            {k: v.clone() for k, v in disc.state_dict().items()}, grads)


@contextlib.contextmanager
def record_masks(store):
    """Keep every dropout keep mask the blocks draw in ``store`` while in
    the block."""
    from patchgan_tpu_torch.models import blocks
    draw = blocks.keep_mask

    def keep(x, generator, mesh=None, band=False):
        mask = draw(x, generator, mesh, band)
        store.append(mask.clone())
        return mask

    blocks.keep_mask = keep
    try:
        yield store
    finally:
        blocks.keep_mask = draw


def step_cases(mesh, outdir, names, jax_weights=None, dropout=False):
    """The named ``CASES`` on this rank, the JAX case on the JAX package's
    weights and batch (``jax_weights``), and with ``dropout`` the dropout
    case with its masks; results into ``outdir/steps_<rank>.pt``."""
    out = {name: run_case(CASES[name], mesh, steps=1) for name in names}
    if jax_weights is not None:
        weights, x, y = torch.load(jax_weights, weights_only=True)
        out['jax'] = run_case(JAX_CASE, mesh, weights, [(x, y)])
    if dropout:
        with record_masks([]) as masks:
            out['dropout'] = run_case(DROPOUT_CASE, mesh)
        out['masks'] = masks
    out['grid'] = (mesh.data.rank, mesh.spatial.rank)
    torch.save(out, os.path.join(outdir, f'steps_{mesh.rank}.pt'))


def dropout_reference():
    """One process's dropout case and the keep masks it draws."""
    with record_masks([]) as masks:
        return run_case(DROPOUT_CASE), masks


# the Trainer


def trainer_epoch(mesh, outdir, data_dir):
    """One epoch of the Trainer over this rank's rows of an npz folder
    (``examples/io_plugin_example.py``'s dataset): its losses, whether the
    parameters are rank 0's after it, and the files each rank wrote."""
    import importlib.util

    from patchgan_tpu_torch.data import DataLoader
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train import Trainer
    from patchgan_tpu_torch.train import trainer as trainer_module
    spec = importlib.util.spec_from_file_location(
        'io_plugin', os.path.join(data_dir, 'io.py'))
    plugin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plugin)
    writes = []
    save = trainer_module.ckpt.save_state_dict
    trainer_module.ckpt.save_state_dict = \
        lambda path, sd: (writes.append(path), save(path, sd))
    gen = UNet(3, dpw.OUT_C, nf=dpw.NF, use_dropout=True,
               generator=torch.Generator().manual_seed(1))
    disc = Discriminator(3 + dpw.OUT_C, ndf=dpw.NF, n_layers=3,
                         generator=torch.Generator().manual_seed(2))
    t = Trainer(gen, disc, os.path.join(outdir, 'ck'), device='cpu', seed=3,
                mesh=mesh)
    t.compute_iou = True
    slicing = dict(process_index=mesh.data.rank,
                   process_count=mesh.data.size, batch_size=4,
                   num_workers=0, seed=0)

    def data(split):
        path = os.path.join(data_dir, split)
        return DataLoader(plugin.NpzSegmentationDataset(
            path, path, size=dpw.SIZE, in_channels=3,
            out_channels=dpw.OUT_C, labels=[1, 2, 3]), **slicing)

    history = t.train(data('train'), data('val'), epochs=1, save_freq=1)
    params = list(gen.parameters()) + list(disc.parameters())
    try:
        mesh.check_replicated(params, 'weights')
        replicated = True
    except RuntimeError:
        replicated = False
    torch.save({'history': history, 'replicated': replicated,
                'writes': writes, 'step': t.step},
               os.path.join(outdir, f'trainer_{mesh.rank}.pt'))


def train_rank(rank, outdir, argv, cwd):
    """``patchgan_train(argv)`` from ``cwd`` (the npz plugin's folder) on a
    rank that sees torchrun's environment: its history and what it printed
    into ``outdir/train_<rank>.pt``."""
    import io
    from patchgan_tpu_torch.cli.train import patchgan_train
    os.chdir(cwd)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        history = patchgan_train(argv)
    torch.save((history, text.getvalue()),
               os.path.join(outdir, f'train_{rank}.pt'))
