"""Evaluation entry point: ``python -m patchgan_tpu_torch.cli.evaluate``.

Port of ``patchgan_tpu/cli/evaluate.py``: the same flags (-c/--config_file,
-b/--batch_size, --dataloader_workers, -d/--device, --dtype, --metrics)
and config keys (the train CLI's dataset schema, either ``model_params``
schema, ``checkpoint_paths.generator`` or ``checkpoint_path``). It runs a
generator checkpoint in eval mode, in the plain form, over a labelled
folder (``validation_data``, else ``dataset_path``; the '+flip'
augmentation is dropped) and prints one JSON line: ``metric``
('mean_iou'), ``value``, ``n_images``, ``checkpoint``, and with
``--metrics iou,dice,bf1`` also ``mean_dice`` and ``mean_boundary_f1``
(boundary F1 at 2 px). Each value is the mean of the per-batch metrics
weighted by the batch sizes, as in the JAX CLI, so the batch size is
part of the result. ``-d auto`` (the default) and ``-d cuda`` run on the
card, where ``--dtype auto`` is bfloat16, and raise without one; ``-d
cpu`` runs on the CPU.

Without ``checkpoint_paths.generator`` the numerically newest
``generator_ep_*.npz`` under ``checkpoint_path`` is evaluated, so one
config drives train-then-eval. One deliberate difference from the JAX
CLI: with ``checkpoint_path`` unset too it raises ValueError, where the
JAX CLI searches the current directory.
"""

import argparse
import glob
import json
import os
import re
import time

import numpy as np
import torch

from ..data import DataLoader
from ..models import UNet
from ..utils import checkpoint as ckpt
from ..utils.config import load_config, model_params
from ..utils.metrics import boundary_f1, dice, iou
from ..utils.transfer import load_transfer_data, unet_key_map
from .common import build_dataset_factory, compute_dtype, select_device

METRICS = {'iou': iou, 'dice': dice, 'bf1': boundary_f1}
LONG_NAMES = {'dice': 'mean_dice', 'bf1': 'mean_boundary_f1'}


def newest_generator(folder):
    """The ``generator_ep_*.npz`` of the largest epoch under ``folder``;
    files of other suffixes are not considered, as in the JAX CLI."""
    epochs = {}
    if folder:
        for path in glob.glob(os.path.join(folder,
                                           f'{ckpt.GEN_PREFIX}*.npz')):
            m = re.fullmatch(rf'{re.escape(ckpt.GEN_PREFIX)}(\d+)\.npz',
                             os.path.basename(path))
            if m:
                epochs[int(m.group(1))] = path
    if not epochs:
        raise ValueError(
            "No generator checkpoint: set checkpoint_paths.generator, or "
            "point checkpoint_path at a folder containing "
            "generator_ep_*.npz")
    return epochs[max(epochs)]


def metric_names(spec):
    """The metrics of a comma list, 'iou' first; unknown names are
    reported and dropped."""
    wanted = [m.strip() for m in spec.split(',') if m.strip()]
    unknown = [m for m in wanted if m not in METRICS]
    if unknown:
        print(f"Ignoring unknown metrics: {', '.join(unknown)}")
    return ['iou'] + [m for m in dict.fromkeys(wanted)
                      if m in METRICS and m != 'iou']


def patchgan_eval(argv=None):
    parser = argparse.ArgumentParser(
        prog='PatchGAN',
        description='Evaluate a generator checkpoint (mean IoU)'
    )
    parser.add_argument('-c', '--config_file', required=True, type=str)
    parser.add_argument('-b', '--batch_size', default=16, type=int)
    parser.add_argument('--dataloader_workers', default=4, type=int)
    parser.add_argument('-d', '--device', default='auto',
                        help="Device: 'auto', 'cuda' or 'cpu'")
    parser.add_argument('--dtype', default='auto',
                        choices=['auto', 'float32', 'bfloat16'])
    parser.add_argument('--metrics', default='iou',
                        help="Comma list from {iou, dice, bf1} "
                             "(boundary F1, 2px tolerance)")
    args = parser.parse_args(argv)

    device = select_device(args.device)
    dtype = compute_dtype(args.dtype, device)

    config = load_config(args.config_file)
    dataset_params = config['dataset']
    size = dataset_params.get('size', 256)
    Dataset, in_channels, out_channels, ds_kwargs = \
        build_dataset_factory(dataset_params)

    # a deterministic resize: random flips must not reach the metrics
    augmentation = dataset_params.get('augmentation', 'randomcrop')
    if isinstance(augmentation, str) and augmentation.endswith('+flip'):
        augmentation = augmentation[:-len('+flip')]
    data = dataset_params.get('validation_data',
                              config.get('validation_data'))
    if data is not None:
        datagen = Dataset(data['images'], data['masks'], size=size,
                          augmentation=augmentation, **ds_kwargs)
    else:
        datagen = Dataset(dataset_params['dataset_path'], size=size,
                          augmentation=augmentation, **ds_kwargs)
    if not getattr(datagen, 'masks', True):
        raise ValueError(
            "Evaluation needs ground-truth masks: point "
            "dataset.validation_data at {images, masks} folders (the "
            "single dataset.dataset_path form found no *.png masks)")

    gen_cfg, _ = model_params(config)
    generator = UNet(input_nc=in_channels, output_nc=out_channels,
                     nf=gen_cfg['filters'],
                     activation=gen_cfg['activation'],
                     final_act=gen_cfg['final_activation'], dtype=dtype,
                     generator=torch.Generator().manual_seed(0))
    # `or {}`: an empty `checkpoint_paths:` key parses to None
    gen_ckpt = (config.get('checkpoint_paths') or {}).get('generator')
    if gen_ckpt is None:
        gen_ckpt = newest_generator(config.get('checkpoint_path'))
        print(f"Evaluating newest checkpoint: {gen_ckpt}")
    count = load_transfer_data(generator, ckpt.load_state_dict(gen_ckpt),
                               verbose=False)
    if count < len(unet_key_map()):
        raise ValueError(f"Generator checkpoint mismatch: {count}/"
                         f"{len(unet_key_map())} weights loaded")
    generator.to(device).eval()

    wanted = metric_names(args.metrics)
    loader = DataLoader(datagen, batch_size=args.batch_size,
                        shuffle=False, drop_last=False,
                        num_workers=max(args.dataloader_workers, 1),
                        device=device, dtype=dtype)
    scores, weights = [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for x, y in loader:
            pred = generator(x)
            # only the batch's scalars go to the host
            scores.append(torch.stack([METRICS[m](y, pred)
                                       for m in wanted]).tolist())
            weights.append(int(x.shape[0]))
            if len(weights) == 1:
                first_s = time.perf_counter() - t0
    elapsed = time.perf_counter() - t0
    if not weights:
        raise ValueError(
            "Evaluation dataset is empty: the configured data "
            "folders yielded zero image/mask pairs, so no metrics can be "
            "computed")
    means = dict(zip(wanted, np.average(np.asarray(scores), axis=0,
                                        weights=weights)))
    n_images = sum(weights)
    # the loader's start and the first batch's set-up kept apart
    rest = n_images - weights[0]
    print(f"Evaluated {n_images} images in {elapsed:.3f}s "
          f"({n_images / elapsed:.1f} img/s)" + (
              f"; after the first batch {rest} images in "
              f"{elapsed - first_s:.6f}s "
              f"({rest / (elapsed - first_s):.1f} img/s)" if rest else ""))

    result = {
        'metric': 'mean_iou',
        'value': round(float(means['iou']), 5),
        'n_images': n_images,
        'checkpoint': gen_ckpt,
    }
    for m in wanted[1:]:
        result[LONG_NAMES[m]] = round(float(means[m]), 5)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    patchgan_eval()
