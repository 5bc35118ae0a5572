"""Hybrid data x model parallelism for the G+D train step: the
counterpart of ``patchgan_tpu/parallel/sharding.py``.

The JAX package lays a 2-D ``(data, model)`` mesh over its devices,
shards every conv kernel over its output-channel axis and every bias over
its only axis (a leaf whose axis does not divide the model axis stays
replicated), shards the batch over ``data``, and lets GSPMD insert the
collectives. The port runs one process per card and does explicitly what
GSPMD does (``parallel/mesh.py``, ``HybridMesh`` and ``ModelMesh``):

- every rank holds its model rank's shard of each sharded parameter and
  of its Adam moments (``place_hybrid_state``), and the replicated ones
  whole;
- a sharded layer takes its whole input, computes its output channels
  (instance norm and the activation are per channel, so they stay on the
  shard: kernels K1-K4 run on it unchanged), and the model group gathers
  them before the next layer (``ModelMesh.gather``; dropout runs after
  the gather, on the whole tensor);
- the gradient of a sharded layer's input is summed over the model group
  (``ModelMesh.enter``); a replicated layer's is whole on every rank;
- every parameter's gradient is summed over the data group only, and the
  losses are the data group's (``DataMesh``), as in data parallelism.

Worth it where one replica's activations or optimizer state outgrow a
card; at config 2 data parallelism alone is faster (PERF.md).
"""

import torch.nn as nn

from .mesh import HybridMesh, rank_grid

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

__all__ = ['DATA_AXIS', 'MODEL_AXIS', 'HybridMesh', 'hybrid_mesh',
           'rank_grid', 'model_parallel_shardings', 'optimizer_state',
           'place_hybrid_state', 'gather_hybrid_state']


def hybrid_mesh(dp, mp, device):
    """The (dp x mp) ``HybridMesh`` over the default process group, this
    rank on ``device``; world rank d * mp + m sits at (d, m)."""
    return HybridMesh(dp, mp, device)


def _layout(module, mp):
    """(state_dict key, parameter, its layer's output channels, the dim it
    is sharded on or None) of every conv parameter of ``module``."""
    for prefix, conv in module.named_modules():
        if not isinstance(conv, (nn.Conv2d, nn.ConvTranspose2d)):
            continue
        for pname, p in conv.named_parameters(recurse=False):
            dim = 1 if p.dim() == 4 and \
                isinstance(conv, nn.ConvTranspose2d) else 0
            yield (f'{prefix}.{pname}' if prefix else pname, p,
                   conv.out_channels,
                   None if conv.out_channels % mp else dim)


def model_parallel_shardings(module, mp):
    """{state_dict key: the torch dim it is sharded on, or None}: a conv
    weight (OIHW) on dim 0, a transposed conv's (IOHW) on dim 1, a bias on
    dim 0, the counterparts of JAX's HWIO ``O`` and its biases' only axis
    (``utils/transfer.py``); replicated (None) where the layer's output
    channels do not divide ``mp``. Read from the layers' declared output
    channels, so a placed module gives the same answer."""
    return {name: dim for name, _, _, dim in _layout(module, mp)}


def _sharded(modules, mp):
    """{id(parameter): (its name, dim, its layer's output channels)} of
    every sharded parameter of ``modules``."""
    return {id(p): (name, dim, whole) for module in modules
            for name, p, whole, dim in _layout(module, mp)
            if dim is not None}


def optimizer_state(opt):
    """(the parameters, the lists of per-parameter state) of a
    ``train.steps`` optimizer: Adam's moments, and ``MultiSteps``'s
    running mean beside them."""
    inner = getattr(opt, 'inner', opt)
    lists = [inner.mu, inner.nu]
    if hasattr(opt, 'acc'):
        lists.append(opt.acc)
    return inner.params, lists


def place_hybrid_state(gen, disc, opts, mesh):
    """Cut every rank's state down to its model rank's shard, in place:
    each sharded parameter's ``.data`` (the parameter object stays, so the
    optimizers still hold it) and its optimizer state in ``opts`` (Adam's
    moments, the bf16 first moment included, and an accumulator), as
    ``place_hybrid_state`` of the JAX package places a TrainState. Every
    rank must hold the same whole state before (the same seed or files)."""
    model = mesh.model
    sharded = _sharded((gen, disc), model.size)
    for module in (gen, disc):
        for p in module.parameters():
            if id(p) not in sharded:
                continue
            name, dim, whole = sharded[id(p)]
            if p.shape[dim] != whole:
                raise ValueError(f'{name} is placed already')
            p.data = model.shard(p.data, dim).clone()
    for opt in opts:
        params, lists = optimizer_state(opt)
        for i, p in enumerate(params):
            if id(p) in sharded:
                dim = sharded[id(p)][1]
                for state in lists:
                    state[i] = model.shard(state[i], dim).clone()


def gather_hybrid_state(gen, disc, opts, mesh):
    """The whole state one process would hold, from the ranks' shards (a
    collective over the model group; the modules stay placed):
    (generator state_dict, discriminator state_dict, [per optimizer a
    dict of its lists of state: 'mu', 'nu' and 'acc' where there is
    one]), new tensors on this rank's device."""
    model = mesh.model
    dims = {key: dim for key, (_, dim, _) in
            _sharded((gen, disc), model.size).items()}
    states = []
    for module in (gen, disc):
        states.append({
            name: model.unshard(p.detach(), dims[id(p)])
            if id(p) in dims else p.detach().clone()
            for name, p in module.named_parameters()})
    opt_states = []
    for opt in opts:
        params, lists = optimizer_state(opt)
        whole = []
        for state in lists:
            whole.append([model.unshard(t, dims[id(p)]) if id(p) in dims
                          else t.clone() for p, t in zip(params, state)])
        opt_states.append(dict(zip(('mu', 'nu', 'acc'), whole)))
    return states[0], states[1], opt_states
