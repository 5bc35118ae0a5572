"""Shared CLI plumbing: device and dtype selection, dataset construction.

Port of ``patchgan_tpu/cli/common.py``.
"""

import os

import torch


def select_device(name):
    """'auto' and 'cuda' mean the card, and raise without one; only 'cpu'
    runs on the CPU. Under a process group they mean this rank's card,
    ``cuda:LOCAL_RANK``."""
    if name == 'cpu':
        return torch.device('cpu')
    if name in ('auto', 'cuda') or name.startswith('cuda:'):
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} needs a CUDA GPU and none "
                               f"is available; pass -d cpu to run on the "
                               f"CPU")
        if name in ('auto', 'cuda') and torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            return torch.device('cuda', int(os.environ.get('LOCAL_RANK',
                                                           0)))
        return torch.device('cuda' if name == 'auto' else name)
    raise ValueError(f"Unknown device {name!r}")


def engine_devices(name):
    """(device, mesh) of an inference engine for ``-d name``: 'auto' and
    'cuda' mean every visible card (``CUDA_VISIBLE_DEVICES``) as one
    ``DeviceMesh``, its first card the device, as the JAX CLIs build
    ``default_mesh()`` over ``jax.devices()``; 'cuda:N' means that card
    alone and 'cpu' the CPU, with no mesh. Raises as ``select_device``."""
    from ..parallel import default_mesh
    device = select_device(name)
    if name in ('auto', 'cuda'):
        mesh = default_mesh()
        return mesh.home, mesh
    return device, None


def refuse_ranks(cli):
    """``cli`` runs one process's job: under torchrun with more than one
    rank it raises, instead of running the same job on every rank."""
    size = int(os.environ.get('WORLD_SIZE', 1))
    if size > 1:
        raise NotImplementedError(
            f"{cli} runs as one process, which already uses every visible "
            f"card (-d cuda); it does not run across {size} ranks: start "
            f"it without torchrun")


def compute_dtype(name, device):
    """'auto' is bfloat16 on the card and float32 on the CPU. float32 on
    the card turns TF32 off for cuDNN and matmuls, keeping the JAX
    package's fp32 semantics."""
    if name == 'auto':
        return torch.bfloat16 if device.type == 'cuda' else torch.float32
    dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[name]
    if device.type == 'cuda' and dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dtype


def build_dataset_factory(dataset_params):
    """Resolve the Dataset class and channel counts from the config's
    ``dataset`` section."""
    from ..data import COCOStuffDataset, TarShardDataset, load_dataset_class

    kwargs = {}
    if dataset_params['type'] in ('COCOStuff', 'TarShards'):
        # TarShards: the images path(s) are tar files or a glob of them,
        # and the masks live inside the shards (data/shards.py)
        cls = COCOStuffDataset if dataset_params['type'] == 'COCOStuff' \
            else TarShardDataset
        in_channels = 3
        labels = dataset_params.get('labels', [1])
        out_channels = len(labels)
        kwargs['labels'] = labels
    else:
        cls = load_dataset_class(dataset_params['type'])
        in_channels = dataset_params.get('in_channels', 3)
        out_channels = dataset_params.get('out_channels', 1)
        if 'labels' in dataset_params:
            # a plugin one-hots over the labels it is given, like the
            # built-in dataset (``examples/io_plugin_example.py``)
            kwargs['labels'] = dataset_params['labels']
    return cls, in_channels, out_channels, kwargs
