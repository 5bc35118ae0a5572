"""Inference entry point: ``python -m patchgan_tpu_torch.cli.infer``.

Port of ``patchgan_tpu/cli/infer.py:34-162``: the same flags and config
keys (flat or nested ``model_params``, ``checkpoint_paths.generator``,
``infer_params.{output_path, threshold, overlap, batch_size, mode}``),
the ``get_filename`` / ``save_mask`` dataset protocol, overlap tiling
with the averaging stitch (``mode: tiled``, the default) or one
whole-image forward (``mode: spatial``), and image decode/save
overlapped with the device.
``-d auto`` (the default) and ``-d cuda`` run one engine over every
visible card (``CUDA_VISIBLE_DEVICES``), as the JAX CLI's
``default_mesh()`` does, and raise without one; ``-d cuda:N`` runs on
that card alone and ``-d cpu`` on the CPU. It runs as one process: under
torchrun with more than one rank it raises.
"""

import argparse
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import torch
import tqdm

from ..inference import InferenceEngine
from ..inference.engine import _ReadyMask
from ..models import UNet
from ..utils import checkpoint as ckpt
from ..utils.config import load_config, model_params
from ..utils.summary import summarize
from ..utils.transfer import load_transfer_data, unet_key_map
from .common import (build_dataset_factory, compute_dtype, engine_devices,
                     refuse_ranks)


def patchgan_infer(argv=None):
    parser = argparse.ArgumentParser(
        prog='PatchGAN',
        description='Run tiled PatchGAN inference'
    )
    parser.add_argument('-c', '--config_file', required=True, type=str,
                        help='Location of the config YAML file')
    parser.add_argument('--dataloader_workers', default=4, type=int,
                        help='Decode threads prefetching images ahead of '
                             'the device')
    parser.add_argument('-d', '--device', default='auto',
                        help="Device to use: 'auto' or 'cuda' (every "
                             "visible card), 'cuda:N' or 'cpu'")
    parser.add_argument('--summary', default=True, action='store_true',
                        help='Print summary of the models')
    parser.add_argument('--dtype', default='auto',
                        choices=['auto', 'float32', 'bfloat16'])
    args = parser.parse_args(argv)

    refuse_ranks('patchgan_infer')
    device, mesh = engine_devices(args.device)
    dtype = compute_dtype(args.dtype, device)
    print(f"Running on {mesh.describe()}" if mesh is not None
          else f"Running with {device}")

    config = load_config(args.config_file)

    dataset_params = config['dataset']
    dataset_path = dataset_params['dataset_path']
    size = dataset_params.get('size', 256)

    Dataset, in_channels, out_channels, ds_kwargs = \
        build_dataset_factory(dataset_params)
    for method in ('get_filename', 'save_mask'):
        if not callable(getattr(Dataset, method, None)):
            raise TypeError(f"Dataset class {Dataset.__name__} must have "
                            f"the {method} method")
    datagen = Dataset(dataset_path, **ds_kwargs)

    infer_params = config.get('infer_params', {})
    mode = infer_params.get('mode', 'tiled')  # tiled | spatial

    gen_cfg, _ = model_params(config)
    generator = UNet(input_nc=in_channels, output_nc=out_channels,
                     nf=gen_cfg['filters'],
                     activation=gen_cfg['activation'],
                     final_act=gen_cfg['final_activation'], dtype=dtype,
                     generator=torch.Generator().manual_seed(0))
    gen_sd = ckpt.load_state_dict(config['checkpoint_paths']['generator'])
    count = load_transfer_data(generator, gen_sd, verbose=False)
    keymap_size = len(unet_key_map())
    if count < keymap_size:
        raise ValueError(
            f"Generator checkpoint mismatch: {count}/{keymap_size} "
            "weights loaded")
    # the discriminator checkpoint key is accepted but never used here

    if args.summary:
        summarize('UNet generator', generator, (1, in_channels, size, size))

    output_path = infer_params.get('output_path', 'predictions/')
    if not os.path.exists(output_path):
        os.makedirs(output_path)
        print(f"Created folder {output_path}")

    engine = InferenceEngine(generator, size=size,
                             overlap=infer_params.get('overlap', 0.9),
                             threshold=infer_params.get('threshold', 0),
                             batch_size=infer_params.get('batch_size', 128),
                             device=device, mesh=mesh)

    def fetch(i):
        if hasattr(datagen, 'get_image'):
            return datagen.get_image(i)
        item = datagen[i]
        return item[0] if isinstance(item, tuple) else item

    # decode runs in a thread pool with a bounded look-ahead; the mask of
    # image i-1 is copied back and saved only after image i's pipeline is
    # queued, so host decode/save overlaps the device
    n = len(datagen)
    workers = max(args.dataloader_workers, 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = deque(pool.submit(fetch, i)
                        for i in range(min(2 * workers, n)))
        next_submit = len(pending)
        prev = None  # (mask handle, output filename) of image i-1
        for i in tqdm.tqdm(range(n), desc='Predicting',
                           dynamic_ncols=True, ascii=True):
            image = pending.popleft().result()
            if next_submit < n:
                pending.append(pool.submit(fetch, next_submit))
                next_submit += 1
            out_fname, _ = os.path.splitext(datagen.get_filename(i))
            if mode == 'tiled':
                handle = engine.predict_image_async(image)
            else:
                handle = _ReadyMask(engine.predict_image(image, mode=mode))
            if prev is not None:
                Dataset.save_mask(prev[0].result(), output_path, prev[1])
            prev = (handle, out_fname)
        if prev is not None:
            Dataset.save_mask(prev[0].result(), output_path, prev[1])


if __name__ == '__main__':
    patchgan_infer()
