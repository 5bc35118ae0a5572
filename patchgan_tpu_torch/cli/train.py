"""Training entry point: ``python -m patchgan_tpu_torch.cli.train``.

Port of ``patchgan_tpu/cli/train.py``: the same flags (-c/--config_file,
-b/--batch_size, --dataloader_workers, --dataloader_worker_type,
-n/--n_epochs, -d/--device, --summary/--no-summary, --dtype, --seed,
--profile_dir) and YAML sections (dataset, both model_params schemas,
checkpoint_path, load_last_checkpoint, transfer_learn, train_params),
the cwd ``io.py`` plugin datasets, resume from the last checkpoint and
transfer learning. ``-d auto`` (the default) and ``-d cuda`` train on
the card and raise without one; ``-d cpu`` trains on the CPU.
``--dtype auto`` is bfloat16 on the card, where Adam's first moment is
then kept in bfloat16 too (``cli/train.py:150-153``).

Fine-tuning (BASELINE.json config 3): ``transfer_learn.generator_checkpoint``
and ``discriminator_checkpoint`` (npz, or a torch ``.pth`` / ``.pt``
state_dict) load shape-matched; ``transfer_learn.freeze_encoder: true``
freezes the encoder (``('enc',)``), or ``transfer_learn.freeze`` lists
JAX path prefixes (``[enc0, dec6]``); ``train_params.accumulate_steps``
applies each update on the mean gradient of that many batches.

The input pipeline: ``dataset.type: TarShards`` reads tar shards
(``train_data.images`` a shard path or glob); ``--dataloader_worker_type
process`` decodes in forkserver worker processes; ``dataset.cache: true``
(or a byte budget) keeps decoded pairs in RAM, so epochs after the first
decode nothing. ``train_params.save_every_steps: N`` writes a rolling
exact-resume state every N batches, and ``load_last_checkpoint: true``
then continues a killed run bit for bit. ``--profile_dir DIR`` writes a
profiler trace of the first epoch. ``--deterministic`` (the port's own)
makes cuDNN pick deterministic algorithms, so two runs from one seed, or
a run and its resumed continuation, give the same bits on the card.

``PATCHGAN_S2D=on|off`` selects the space-to-depth boundary form of the
step, as in the JAX package (``ops/s2d.py``). On the card each batch
shape's train step runs eagerly once, is then captured as one CUDA graph
and replayed (``train/graph.py``, the counterpart of the JAX package's
jitted step); ``PATCHGAN_CUDA_GRAPH=off`` (or 0, false) runs every step
eagerly. ``--deterministic`` holds for both.

Data parallelism (BASELINE.json config 5): launched by ``torchrun``,
one process per card,

    torchrun --nproc_per_node 4 -m patchgan_tpu_torch.cli.train -c train.yaml -n 10 -b 16

each rank trains on ``cuda:LOCAL_RANK`` over NCCL (``-d cpu``: gloo on
the CPU) with ``-b`` the global batch, as in the JAX CLI: each rank
decodes and steps on ``b / ranks`` rows of every batch, the losses and
updates are those of one process on the whole batch, and rank 0 alone
writes the checkpoints (``train/trainer.py``). A ``-b`` that does not
divide across the ranks raises. Without torchrun's environment nothing
of this applies.

Spatial parallelism (JAX ``cli/train.py:105-118``):
``train_params.spatial_parallelism: sp`` under torchrun splits every
image's rows over ``sp`` ranks and the batch over world size / ``sp``
(``parallel/spatial.py``); ``sp`` must divide the world size (one process
is a world of 1), and ``-b`` the data ranks. The epoch lines say
"Spatial parallel: dp x sp ranks".

Not ported yet, and refused with NotImplementedError naming ROADMAP.md:
the Trainer's orbax ``checkpoint_format`` (item 12).
"""

import argparse

import torch

from ..data import DataLoader
from ..data.split import random_split
from ..models import Discriminator, UNet
from ..parallel import init_from_env, shutdown, torchrun_env
from ..train import Trainer
from ..utils.config import dataset_paths, load_config, model_params
from ..utils.summary import summarize
from .common import build_dataset_factory, compute_dtype, select_device


def patchgan_train(argv=None):
    parser = argparse.ArgumentParser(
        prog='PatchGAN',
        description='Train the PatchGAN architecture',
        epilog='Environment: PATCHGAN_S2D=on|off selects the '
               'space-to-depth form of the step (default off); '
               'PATCHGAN_CUDA_GRAPH=on|off runs the train step on the card '
               'as a captured CUDA graph (default on) or eagerly.'
    )
    parser.add_argument('-c', '--config_file', required=True, type=str,
                        help='Location of the config YAML file')
    parser.add_argument('-b', '--batch_size', default=16, type=int,
                        help='Number of images per batch (the global '
                             'batch under torchrun)')
    parser.add_argument('--dataloader_workers', default=4, type=int,
                        help='Number of decode threads (0 decodes in the '
                             'producer thread)')
    parser.add_argument('--dataloader_worker_type', default='thread',
                        choices=['thread', 'process'],
                        help="'thread' (GIL-free native decode, supports "
                             "the RAM cache) or 'process' (forkserver "
                             "worker processes)")
    parser.add_argument('-n', '--n_epochs', required=True, type=int,
                        help='Number of epochs to train the model')
    parser.add_argument('-d', '--device', default='auto',
                        help="Device to train on: 'auto', 'cuda' or 'cpu'")
    parser.add_argument('--summary', dest='summary', default=True,
                        action='store_true',
                        help='Print summary of the models (default)')
    parser.add_argument('--no-summary', dest='summary',
                        action='store_false',
                        help='Skip the model summary tables')
    parser.add_argument('--dtype', default='auto',
                        choices=['auto', 'float32', 'bfloat16'],
                        help='Compute dtype (default: bf16 on the card, '
                             'fp32 on the CPU)')
    parser.add_argument('--seed', default=0, type=int)
    parser.add_argument('--profile_dir', default=None,
                        help='Write a profiler trace of the first training '
                             'epoch into this directory')
    parser.add_argument('--deterministic', action='store_true',
                        help="cuDNN's deterministic algorithms: the same "
                             "seed gives the same bits, a resume continues "
                             "bit for bit")
    args = parser.parse_args(argv)

    config = load_config(args.config_file)
    sp = int(config['train_params'].get('spatial_parallelism') or 1)
    env = torchrun_env()
    world = 1 if env is None else env[1]
    if world % sp:
        raise ValueError(f"spatial_parallelism {sp} must divide the world "
                         f"size {world}")
    if args.batch_size % (world // sp):
        ranks = f'{world} ranks' if sp == 1 else f'{world // sp} data ranks'
        raise ValueError(
            f"-b {args.batch_size} is the global batch and does not "
            f"divide across {ranks}")
    mesh = init_from_env(on_cpu=args.device == 'cpu', sp=sp)
    try:
        return _train(args, mesh, config)
    finally:
        shutdown(mesh)


def _train(args, mesh, config):
    device = select_device(args.device)
    dtype = compute_dtype(args.dtype, device)
    slicing = {}
    if mesh is None:
        print(f"Running with {device}")
    else:
        print(f"Running with {device}, rank {mesh.rank} of {mesh.size}")
        # each rank decodes its data rank's rows (a spatial step takes its
        # band of them)
        slicing = dict(process_index=mesh.data.rank,
                       process_count=mesh.data.size)
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    dataset_params = config['dataset']
    train_params = config['train_params']
    train_paths, val_paths, data_paths, split = dataset_paths(config)
    size = dataset_params.get('size', 256)
    augmentation = dataset_params.get('augmentation', 'randomcrop')

    Dataset, in_channels, out_channels, ds_kwargs = \
        build_dataset_factory(dataset_params)

    def make_ds(paths):
        return Dataset(paths['images'], paths['masks'], size=size,
                       augmentation=augmentation, **ds_kwargs)

    if split is None:
        train_datagen = make_ds(train_paths)
        val_datagen = make_ds(val_paths)
    else:
        train_datagen, val_datagen = random_split(make_ds(data_paths),
                                                  split, seed=args.seed)

    # dataset.cache: true for an unbounded decoded-image RAM cache, or a
    # byte budget; epochs after the first then skip the decoder
    loader_kwargs = dict(batch_size=args.batch_size, shuffle=True,
                         num_workers=args.dataloader_workers,
                         device=device, dtype=dtype, seed=args.seed,
                         cache=dataset_params.get('cache', False),
                         worker_type=args.dataloader_worker_type, **slicing)
    train_data = DataLoader(train_datagen, drop_last=True, **loader_kwargs)
    val_data = DataLoader(val_datagen, drop_last=False, **loader_kwargs)

    gen_cfg, disc_cfg = model_params(config)
    init = torch.Generator().manual_seed(args.seed)
    generator = UNet(input_nc=in_channels, output_nc=out_channels,
                     nf=gen_cfg['filters'],
                     use_dropout=gen_cfg['use_dropout'],
                     activation=gen_cfg['activation'],
                     final_act=gen_cfg['final_activation'], dtype=dtype,
                     generator=init)
    discriminator = Discriminator(input_nc=in_channels + out_channels,
                                  ndf=disc_cfg['filters'],
                                  norm=disc_cfg['norm'],
                                  n_layers=disc_cfg['n_layers'],
                                  dtype=dtype, generator=init)

    trainer = Trainer(generator, discriminator,
                      savefolder=config.get('checkpoint_path',
                                            './checkpoints/'),
                      device=device, seed=args.seed, mesh=mesh)
    if dtype == torch.bfloat16:
        trainer.adam_mu_dtype = torch.bfloat16

    if args.summary and trainer.is_main:
        summarize('UNet generator', generator, (1, in_channels, size, size))
        summarize('Discriminator', discriminator,
                  (1, in_channels + out_channels, size, size))

    if config.get('load_last_checkpoint', False):
        trainer.load_last_checkpoint()
    elif config.get('transfer_learn', {}).get('generator_checkpoint',
                                              None) is not None:
        tl = config['transfer_learn']
        trainer.load_transfer_checkpoints(tl['generator_checkpoint'],
                                          tl['discriminator_checkpoint'])
        if tl.get('freeze_encoder', False):
            trainer.freeze_generator = ('enc',)
        elif tl.get('freeze'):
            trainer.freeze_generator = tuple(tl['freeze'])

    trainer.loss_type = train_params['loss_type']
    trainer.seg_alpha = train_params['seg_alpha']
    trainer.bce_weighting = train_params.get('bce_weighting', 'complement')
    trainer.compute_iou = train_params.get('compute_iou', False)
    trainer.save_every_steps = train_params.get('save_every_steps')
    trainer.accumulate_steps = train_params.get('accumulate_steps', 1)
    trainer.profile_dir = args.profile_dir

    try:
        return trainer.train(
            train_data, val_data, args.n_epochs,
            dsc_learning_rate=train_params['disc_learning_rate'],
            gen_learning_rate=train_params['gen_learning_rate'],
            lr_decay=train_params.get('decay_rate', None),
            save_freq=train_params.get('save_freq', 10))
    finally:
        train_data.close()
        val_data.close()


if __name__ == '__main__':
    patchgan_train()
