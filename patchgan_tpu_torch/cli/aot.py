"""``patchgan_aot`` on the card: the pre-flight of a training config.

    python -m patchgan_tpu_torch.cli.aot -c train.yaml -d cuda
    python -m patchgan_tpu_torch.cli.aot --batch 64 --size 512 --gen-filts 128

Port of ``patchgan_tpu/cli/aot.py``. The JAX CLI compiles the train step
for a detached TPU topology; CUDA has no compile against a card that is
not there, so this pre-flight runs on the card it checks. It builds the
models and optimizers at the config as ``patchgan_train`` does, runs the
captured step (``train/graph.py``) on a seeded synthetic batch (its
eager steps, the capture, one replay) and reports:

- whether the step captured and replayed (``compile_ok``);
- FLOPs per step, counted by ``FlopCounterMode`` through the plain path
  on the CPU at batch 1, times the batch: the counter cannot see the
  hand-written kernels, whose plain versions do the same products. The
  count holds every conv and convT forward, the recompute of K2's and
  K3's levels in their backward, and every gradient product the step
  takes. From it the step's bound, FLOPs over the card's peak (989
  TFLOP/s in bf16, 67 in fp32), and the img/s ceiling it implies. The
  recompute is work the port chooses to do, not the model's: a human
  line gives its FLOPs and the count and bound without it;
- ``torch.cuda.max_memory_allocated`` against the card's memory ("will
  it fit"). An out-of-memory error in the eager steps, before any
  capture is open, reports ``fits: false`` and exits 0; any other
  failure reports ``compile_ok: false`` and exits 1.

The flags are the JAX CLI's (-c, --batch (global), --size, --dtype,
--gen-filts, --disc-filts, --no-s2d), plus -d (``cuda``, the default,
needs a card; ``cpu`` runs the same steps eagerly on the CPU and reports
no memory). ``--dp N`` pre-flights data-parallel training over N cards
(``torchrun``, one process per card) on this one card: the step at the
per-rank batch (``--batch`` / N, which must divide), its FLOPs, bound
and peak memory per rank, the gradient bucket each step all-reduces
(the generator's and the discriminator's fp32 gradients) and the ring
all-reduce's lower bound, 2 (N - 1) / N of the bucket's bytes over
NVLink's 450 GB/s each way (an H100 host's cards, all to all).
``--tp T`` above 1 pre-flights data x model parallel training
(``parallel/sharding.py``) on a (D, T) grid of ranks, one process per
card under ``torchrun`` with world size D x T (``--dp`` D, default
world / T; NCCL on the card, gloo with ``-d cpu``): every rank builds
the same models, keeps its shard of each conv whose output channels
divide T, and runs the step at its data rank's rows; rank 0 reports,
per rank, the FLOPs (the sharded convs' count over T, the replicated
ones whole: counted on one rank's shards), the parameter and Adam
moment bytes, the peak memory, the gradient all-reduce over the D ranks
of a data group, and the activation gathers of a step over the T ranks
of a model group with their backward sums, each beside its ring bound
over NVLink. ``--topology`` is not taken (no detached topology). The form
and layout are the Trainer's: space-to-depth when ``PATCHGAN_S2D`` selects
it and ``--no-s2d`` is not given; else channels_last where
``PATCHGAN_AUTO_LAYOUT`` is on (``train/auto_layout.py``) and the step is
one process's (no ``--dp`` or ``--tp`` above 1), NCHW otherwise: the peak
reported is the chosen layout's. ``--shadow`` (JAX ``cli/aot.py:79-80``)
runs the step with the generator's shadow in the compute dtype, as the
Trainer does beside the layout (not under ``--tp``).

Prints human-readable lines (the layout among them), then ONE JSON line
with the JAX CLI's keys (``topology`` null).
"""

import argparse
import json
import sys

import torch

from ..parallel.mesh import ModelMesh

PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}   # H100 SXM, dense
NVLINK_BYTES = 450e9   # bytes/s each way between an H100 host's cards


def _models(in_c, out_c, gen_cfg, disc_cfg, dtype, device, seed=0):
    from ..models import Discriminator, UNet
    init = torch.Generator().manual_seed(seed)
    gen = UNet(input_nc=in_c, output_nc=out_c, nf=gen_cfg['filters'],
               use_dropout=gen_cfg['use_dropout'],
               activation=gen_cfg['activation'],
               final_act=gen_cfg['final_activation'], dtype=dtype,
               generator=init).to(device)
    disc = Discriminator(input_nc=in_c + out_c, ndf=disc_cfg['filters'],
                         norm=disc_cfg['norm'], n_layers=disc_cfg['n_layers'],
                         dtype=dtype, generator=init).to(device)
    gen.dropout_generator = torch.Generator(device=device).manual_seed(seed)
    return gen, disc


def _step(gen, disc, mu_dtype, s2d, loss_kwargs, graph, mesh=None,
          layout=None, shadow_dtype=None):
    """(the train step, its G and D optimizers); over a ``mesh`` with a
    model axis, the state placed on it first; in ``layout``, the models
    converted to it first."""
    from ..parallel.sharding import place_hybrid_state
    from ..train.auto_layout import to_layout
    from ..train.steps import make_optimizer, make_train_step
    if layout is not None:
        to_layout((gen, disc), layout=layout)
    opts = (make_optimizer(gen.parameters(), mu_dtype=mu_dtype),
            make_optimizer(disc.parameters(), mu_dtype=mu_dtype))
    if mesh is not None and mesh.model is not None:
        place_hybrid_state(gen, disc, opts, mesh)
    return make_train_step(gen, disc, *opts, s2d=s2d, graph=graph,
                           mesh=mesh, layout=layout,
                           shadow_dtype=shadow_dtype, **loss_kwargs), opts


def _batch(n, in_c, out_c, size, dtype, device, seed=0):
    """Seeded uniform images and one-hot masks, made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((n, in_c, size, size), generator=g, device=device)
    labels = torch.randint(0, out_c, (n, 1, size, size), generator=g,
                           device=device)
    y = labels == torch.arange(out_c, device=device).view(1, out_c, 1, 1)
    return x.to(dtype), y.to(dtype)


class _CountedAxis(ModelMesh):
    """The model axis of one of ``size`` ranks as one process counts it:
    the shapes a rank sees, no communication (a gather stacks copies of
    this rank's shard). Counts the elements the gathers return
    (``gathered``) and the backward sums reduce (``reduced``)."""

    def __init__(self, size):
        self.rank, self.size, self.backend = 0, size, 'none'
        self.group = self.graph_group = None
        self.gathered = self.reduced = 0

    def _all_gather(self, t, group):
        self.gathered += t.numel() * self.size
        return [t] * self.size

    def _all_reduce(self, t, group):
        self.reduced += t.numel()


class _CountedMesh:
    """A step's mesh of one rank of a (1, ``mp``) grid, for counting: no
    data axis, the model axis a ``_CountedAxis``."""

    def __init__(self, mp):
        self.data, self.model = None, _CountedAxis(mp)


def rank_step_counts(in_c, out_c, size, gen_cfg, disc_cfg, s2d,
                     loss_kwargs, mp=1):
    """(FLOPs of one rank's train step, FLOPs of its recompute, the
    elements its model axis gathers and sums (None at ``mp`` 1)) at
    batch 1, counted through the plain path on the CPU in fp32 on one
    rank's shards of a model axis of ``mp`` ranks. The step runs the
    generator's forward once, so the recompute is the generator's
    forward convs in the step less those of a forward alone."""
    from torch.utils.flop_counter import FlopCounterMode
    gen, disc = _models(in_c, out_c, gen_cfg, disc_cfg, torch.float32,
                        torch.device('cpu'))
    mesh = _CountedMesh(mp) if mp > 1 else None
    step, _ = _step(gen, disc, None, s2d, loss_kwargs, graph=False,
                    mesh=mesh)
    x, y = _batch(1, in_c, out_c, size, torch.float32, torch.device('cpu'))
    conv = torch.ops.aten.convolution
    with FlopCounterMode(display=False) as counter:
        step(x, y)
    in_step = counter.get_flop_counts()['UNet'][conv]
    traffic = None if mesh is None else \
        {'gathered': mesh.model.gathered, 'reduced': mesh.model.reduced}
    with FlopCounterMode(display=False) as alone, torch.no_grad():
        gen(x, s2d=s2d, mesh=mesh)
    return (counter.get_total_flops(),
            in_step - alone.get_flop_counts()['UNet'][conv], traffic)


def step_flops(in_c, out_c, size, gen_cfg, disc_cfg, s2d, loss_kwargs):
    """(FLOPs of one train step, FLOPs of its recompute) at batch 1
    (``rank_step_counts`` of one process)."""
    return rank_step_counts(in_c, out_c, size, gen_cfg, disc_cfg, s2d,
                            loss_kwargs)[:2]


def _config(args):
    """(in_c, out_c, size, generator config, discriminator config, loss
    kwargs) from the YAML and the flags, as ``patchgan_train`` reads
    them."""
    from ..utils.config import load_config, model_params
    config = load_config(args.config_file) if args.config_file else {}
    gen_cfg, disc_cfg = model_params(config)
    ds = config.get('dataset', {})
    in_c, size = ds.get('in_channels', 3), ds.get('size', 256)
    out_c = len(ds.get('labels', [1])) \
        if ds.get('type') in ('COCOStuff', 'TarShards') \
        else ds.get('out_channels', 1)
    tp = config.get('train_params', {})
    loss_kwargs = dict(loss_type=tp.get('loss_type', 'tversky'),
                       seg_alpha=float(tp.get('seg_alpha', 200.0)),
                       bce_weighting=tp.get('bce_weighting', 'complement'))
    if loss_kwargs['loss_type'] == 'fc_tversky':
        loss_kwargs['loss_type'] = 'tversky'
    if args.gen_filts:
        gen_cfg['filters'] = args.gen_filts
    if args.disc_filts:
        disc_cfg['filters'] = args.disc_filts
    if args.size:
        size = args.size
    return in_c, out_c, size, gen_cfg, disc_cfg, loss_kwargs


def patchgan_aot(argv=None):
    parser = argparse.ArgumentParser(
        prog='patchgan_aot',
        description='Pre-flight a training config on the card: capture '
                    'its train step, count its FLOPs, check its memory')
    parser.add_argument('-c', '--config_file', default=None,
                        help='train YAML (dataset / model_params / '
                             'train_params); the flags below override it')
    parser.add_argument('--dp', type=int, default=None,
                        help='data-parallel ways: ranks, one card each '
                             '(with --tp: default world size / tp)')
    parser.add_argument('--tp', type=int, default=1,
                        help='tensor-parallel ways: each conv\'s output '
                             'channels split over this many ranks, one '
                             'card each, under torchrun')
    parser.add_argument('--batch', type=int, default=16,
                        help='GLOBAL batch size')
    parser.add_argument('--size', type=int, default=None,
                        help='image size (default: dataset.size or 256)')
    parser.add_argument('--dtype', default='bfloat16',
                        choices=['float32', 'bfloat16'])
    parser.add_argument('--gen-filts', type=int, default=None)
    parser.add_argument('--disc-filts', type=int, default=None)
    parser.add_argument('--no-s2d', action='store_true',
                        help='the plain boundary form even when '
                             'PATCHGAN_S2D selects the space-to-depth one')
    parser.add_argument('--shadow', action='store_true',
                        help='the step with the generator\'s shadow in the '
                             'compute dtype (the Trainer\'s default beside '
                             'the channels_last layout)')
    parser.add_argument('-d', '--device', default='cuda',
                        help="'cuda' (the card; raises without one) or "
                             "'cpu' (eager, no memory report)")
    args = parser.parse_args(argv)
    if args.shadow and args.tp > 1:
        raise ValueError("--shadow under --tp is not ported: the shadow "
                         "step runs on one process's state")
    dp, tp = _grid(args)
    if args.batch % dp:
        raise ValueError(f"--batch {args.batch} (the global batch) does "
                         f"not divide across --dp {dp} ranks")
    mesh = None
    if tp > 1:
        from ..parallel.mesh import init_from_env, shutdown
        mesh = init_from_env(on_cpu=args.device == 'cpu', mp=tp)
    try:
        return _preflight(args, dp, tp, mesh)
    finally:
        if mesh is not None:
            shutdown(mesh)


def _grid(args):
    """(dp, tp) of the flags; ``--tp`` above 1 needs torchrun's world of
    dp x tp ranks (``--dp`` defaults to world / tp)."""
    tp = args.tp
    if tp < 1:
        raise ValueError(f"--tp {tp} must be 1 or more")
    if tp == 1:
        dp = args.dp or 1
        if dp < 1:
            raise ValueError(f"--dp {dp} must be 1 or more")
        return dp, tp
    from ..parallel.mesh import torchrun_env
    env = torchrun_env()
    if env is None:
        dp = args.dp or 1
        raise ValueError(
            f"--tp {tp} runs one process per card: launch it under "
            f"torchrun with {dp * tp} processes, e.g. python -m "
            f"torch.distributed.run --nproc_per_node {dp * tp} -m "
            f"patchgan_tpu_torch.cli.aot --dp {dp} --tp {tp} ...")
    world = env[1]
    dp = args.dp or world // tp
    if dp < 1 or dp * tp != world:
        raise ValueError(f"--dp {dp} x --tp {tp} needs {dp * tp} ranks, "
                         f"but the world size is {world}")
    return dp, tp


def _preflight(args, dp, tp, mesh):
    """The pre-flight on this process's card (or the CPU): one rank of a
    (dp, tp) grid over ``mesh``, or one process (``mesh`` None) standing
    for each of ``dp`` data-parallel ranks. Rank 0 reports."""
    from ..ops.s2d import s2d_enabled
    from ..train.auto_layout import LAYOUT, auto_layout_enabled
    from .common import compute_dtype, select_device
    batch = args.batch // dp
    device = select_device(args.device) if mesh is None else mesh.device
    dtype = compute_dtype(args.dtype, device)
    in_c, out_c, size, gen_cfg, disc_cfg, loss_kwargs = _config(args)
    s2d = not args.no_s2d and s2d_enabled() and size % 2 == 0
    layout = LAYOUT if (auto_layout_enabled() and not s2d
                        and dp * tp == 1) else None
    shadow_dtype = dtype if args.shadow else None
    on_card = device.type == 'cuda'
    main = mesh is None or mesh.is_main
    kind = torch.cuda.get_device_name(device) if on_card else 'cpu'
    result = {'metric': 'aot_compile', 'topology': None,
              'device_kind': kind, 'devices': dp * tp,
              'mesh': {'data': dp, 'model': tp}, 'batch': args.batch,
              'size': size, 'dtype': args.dtype, 's2d': s2d,
              'shadow': args.shadow, 'gen_filts': gen_cfg['filters'],
              'disc_filts': disc_cfg['filters']}

    flops, recompute, traffic = rank_step_counts(
        in_c, out_c, size, gen_cfg, disc_cfg, s2d, loss_kwargs, tp)
    flops, recompute = flops * batch, recompute * batch
    opt_s = flops / PEAK_FLOPS[args.dtype]
    cost = {'flops_per_device': flops, 'hbm_bytes_per_device': None,
            'optimal_seconds': opt_s,
            'img_per_s_ceiling': args.batch / opt_s}
    capacity = torch.cuda.get_device_properties(device).total_memory \
        if on_card else None
    report = _report if main else (lambda *a, **k: None)
    if main:
        print(f"layout {layout or 'nchw'} (PATCHGAN_AUTO_LAYOUT; "
              f"channels_last takes one process and the plain form)")

    # the models, the optimizers (Adam's first moment in bf16 beside a
    # bf16 step, as patchgan_train keeps it) and the batch, then the
    # eager steps: an out-of-memory error here means "does not fit"
    mu_dtype = torch.bfloat16 if dtype == torch.bfloat16 else None
    try:
        gen, disc = _models(in_c, out_c, gen_cfg, disc_cfg, dtype, device)
        step, opts = _step(gen, disc, mu_dtype, s2d, loss_kwargs,
                           graph=on_card, mesh=mesh, layout=layout,
                           shadow_dtype=shadow_dtype)
        x, y = _batch(args.batch if mesh else batch, in_c, out_c, size,
                      dtype, device)
        if mesh is not None:
            x, y = mesh.local_rows((x, y))
        if on_card:
            # the peak from here on: what the models, the optimizers, the
            # batch and the step hold
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        args_bytes = torch.cuda.memory_allocated(device) if on_card \
            else None
        for _ in range(step.warmup if on_card else 1):
            step(x, y)
    except torch.cuda.OutOfMemoryError as e:
        gen = disc = step = opts = x = y = None
        torch.cuda.empty_cache()
        result.update(compile_ok=None, cost=cost, error=str(e)[:400])
        result['memory_per_device'] = {
            'arguments_bytes': None, 'temp_bytes': None,
            'output_bytes': None, 'peak_bytes': None,
            'hbm_capacity_bytes': capacity, 'fits': False}
        report(result, args, 'out of memory in the eager step', recompute)
        return result
    try:
        losses = step(x, y)   # the capture and its first replay
        values = [float(v) for v in losses.values()]
        if not all(v == v and abs(v) != float('inf') for v in values):
            raise FloatingPointError(f'losses {values}')
        if on_card and not step.replays:
            raise RuntimeError('the step was not replayed')
    except Exception as e:
        result.update(compile_ok=False,
                      error=f'{type(e).__name__}: {e}'[:400])
        print(f'CAPTURE FAILED: {e}', file=sys.stderr)
        if main:
            print(json.dumps(result))
        raise SystemExit(1)
    result.update(compile_ok=True, cost=cost)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    result['memory_per_device'] = {
        'arguments_bytes': args_bytes,
        'temp_bytes': peak - args_bytes if on_card else None,
        'output_bytes': 4 * len(values),
        'peak_bytes': peak, 'hbm_capacity_bytes': capacity,
        'fits': peak < capacity if on_card else None}
    report(result, args, 'captured and replayed' if on_card
           else 'eager on the CPU (no capture)', recompute,
           allreduce_bound(opts, dp),
           None if mesh is None else model_axis_bound(
               traffic, batch, dtype, tp, (gen, disc), opts))
    return result


def allreduce_bound(opts, ranks):
    """The gradient bucket a data-parallel step sums over ``ranks`` (the
    fp32 gradients of the parameters that ``opts``, the G and D
    optimizers, hold: a frozen parameter takes none) and the ring
    all-reduce's lower bound: each rank sends and receives 2 (N - 1) / N
    of the bucket over NVLink."""
    values = sum(p.numel() for opt in opts for p in opt.params)
    ring = 2 * (ranks - 1) / ranks * 4 * values
    return {'ranks': ranks, 'bucket_values': values,
            'bucket_bytes': 4 * values, 'ring_bytes_per_rank': ring,
            'nvlink_bound_ms': ring / NVLINK_BYTES * 1e3}


def model_axis_bound(traffic, batch, dtype, tp, modules, opts):
    """What one rank of a model axis of ``tp`` ranks holds and moves a
    step at ``batch`` rows: its parameters' and optimizer state's bytes,
    the activations its gathers return (``traffic``, elements at batch 1,
    in the compute ``dtype``) and the gradients their backward sums, each
    with its ring's lower bound over NVLink: a gather receives (tp - 1) /
    tp of the whole, an all-reduce sends and receives 2 (tp - 1) / tp."""
    size = torch.tensor([], dtype=dtype).element_size()
    gathered = traffic['gathered'] * batch * size
    reduced = traffic['reduced'] * batch * size
    ring_gather = (tp - 1) / tp * gathered
    ring_reduce = 2 * (tp - 1) / tp * reduced
    from ..parallel.sharding import optimizer_state
    moments = [t for opt in opts for state in optimizer_state(opt)[1]
               for t in state]
    return {'ranks': tp,
            'param_bytes': sum(p.numel() * p.element_size()
                               for m in modules for p in m.parameters()),
            'moment_bytes': sum(t.numel() * t.element_size()
                                for t in moments),
            'gather_bytes': gathered, 'gather_ring_bytes_per_rank':
            ring_gather, 'gather_nvlink_bound_ms':
            ring_gather / NVLINK_BYTES * 1e3,
            'reduce_bytes': reduced, 'reduce_ring_bytes_per_rank':
            ring_reduce, 'reduce_nvlink_bound_ms':
            ring_reduce / NVLINK_BYTES * 1e3}


def _report(result, args, status, recompute, allreduce=None, model=None):
    gib = 1 << 30
    cost, mem = result['cost'], result['memory_per_device']
    ranks, dp = result['devices'], result['mesh']['data']
    print(f"{result['device_kind']}, batch {args.batch} "
          f"({args.batch // dp} a rank, {ranks} ranks: "
          f"{result['mesh']}), {result['size']}px, "
          f"{args.dtype}, s2d={result['s2d']}, "
          f"shadow={result['shadow']}, gen_filts "
          f"{result['gen_filts']}, disc_filts {result['disc_filts']}")
    print(f'  step: {status}')
    print(f"  cost: {cost['flops_per_device'] / 1e9:.1f} GFLOP a step"
          f"{' per rank' if ranks > 1 else ''}; "
          f"bound on an H100 {cost['optimal_seconds'] * 1e3:.3f} ms "
          f"(<= {cost['img_per_s_ceiling']:.0f} img/s)")
    without = cost['flops_per_device'] - recompute
    print(f"  of it the recompute of K2's and K3's levels "
          f"{recompute / 1e9:.1f} GFLOP; without it {without / 1e9:.1f} "
          f"GFLOP, bound {without / PEAK_FLOPS[args.dtype] * 1e3:.3f} ms")
    if model is not None:
        print(f"  per rank: parameters {model['param_bytes'] / 1e6:.1f} MB,"
              f" optimizer state {model['moment_bytes'] / 1e6:.1f} MB")
        print(f"  activation gathers over the {model['ranks']} ranks of a "
              f"model group: {model['gather_bytes'] / 1e6:.1f} MB a step "
              f"gathered, ring bound "
              f"{model['gather_nvlink_bound_ms']:.3f} ms "
              f"({model['gather_ring_bytes_per_rank'] / 1e6:.1f} MB a "
              f"rank); their backward sums "
              f"{model['reduce_bytes'] / 1e6:.1f} MB, ring bound "
              f"{model['reduce_nvlink_bound_ms']:.3f} ms; NVLink at "
              f"{NVLINK_BYTES / 1e9:.0f} GB/s each way")
    if allreduce and allreduce['ranks'] > 1:
        print(f"  gradient all-reduce: {allreduce['bucket_values']} fp32 "
              f"values, {allreduce['bucket_bytes'] / 1e6:.1f} MB a step; "
              f"over {allreduce['ranks']} ranks the ring bound is "
              f"{allreduce['nvlink_bound_ms']:.3f} ms "
              f"({allreduce['ring_bytes_per_rank'] / 1e6:.1f} MB a rank "
              f"at {NVLINK_BYTES / 1e9:.0f} GB/s each way)")
    if mem['fits'] is None:
        print('  memory: not measured (no card)')
    elif mem['peak_bytes'] is None:
        print(f"  memory: DOES NOT FIT in "
              f"{mem['hbm_capacity_bytes'] / gib:.1f} GiB")
    else:
        print(f"  memory: models, optimizers and batch "
              f"{mem['arguments_bytes'] / gib:.2f} GiB, peak "
              f"{mem['peak_bytes'] / gib:.2f} GiB of "
              f"{mem['hbm_capacity_bytes'] / gib:.1f} GiB -> "
              + ('FITS' if mem['fits'] else 'DOES NOT FIT'))
    print(json.dumps(result))


if __name__ == '__main__':
    patchgan_aot()
