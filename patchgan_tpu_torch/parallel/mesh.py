"""Device meshes: the counterpart of ``patchgan_tpu/parallel/mesh.py``.

Three meshes stand for the JAX package's one. ``DeviceMesh`` is the 1-D
mesh over the cards of one process (``default_mesh``): the inference
engine keeps a replica of its weights on each device of it (the
counterpart of ``replicate``) and splits each bucket of tiles over them
(the counterpart of ``shard_batch``). ``DataMesh`` is data parallelism
across processes, described below. ``HybridMesh`` is the 2-D (data,
model) grid of ``parallel/sharding.py``: a ``DataMesh`` over each data
group and a ``ModelMesh``, whose ranks split every conv's output
channels, over each model group. ``parallel/spatial.py``'s
``SpatialMesh`` is the 2-D (data, spatial) grid, whose spatial groups
split every image's rows.

The JAX package lays a 1-D ``data`` mesh over the local devices, shards
each batch on its leading axis, replicates the parameters and lets XLA
insert the gradient psum into the jitted step. The port runs one process
per card (``torchrun``), and a ``DataMesh`` over the default
``torch.distributed`` group stands for that mesh: NCCL between cards,
gloo on the CPU (and between processes that share one card). Each rank
holds ``global batch / size`` rows of every batch (``local_rows``, the
counterpart of ``shard_batch``), and the step does explicitly what XLA
does for a sharded batch:

- ``mean(x)``: the mean over the ranks of a per-rank batch mean, which
  is the global batch's mean because the shards are equal. Its backward
  hands each rank ``1 / size`` of the incoming gradient and communicates
  nothing, so a loss that every rank computes identically from it has,
  on each rank, the gradient of the global loss with respect to that
  rank's own samples. (``torch.distributed.nn``'s all-reduce would
  all-reduce the gradient again in its backward: ``size`` times too
  large.)
- ``stat(t)``: the sum over the ranks of a statistic that takes no
  gradient (a class count, an IoU's sum and count).
- ``sum_(tensors)``: the in-place sum over the ranks of a list of
  tensors of one dtype (the gradients), as one flattened bucket.
- ``check_replicated(tensors, what)``: the group's first rank's values
  broadcast and compared with every rank's own; a rank that differs
  raises.

So the gradient all-reduce sums, and every loss a step reports is the
global batch's, on every rank. With one rank every collective leaves
its values' bits as they are. A step built without a mesh (``mesh=None``)
runs no collective at all.

Gloo takes CUDA tensors as they are (it stages them through host memory
itself); a gloo collective cannot be captured into a CUDA graph, NCCL's
can (``train/graph.py``). Under NCCL the collectives that a capture
records go through a communicator of their own (``graph_group``), and
the eager ones (an eager step's, the eval step's, ``barrier``,
``check_replicated``) through the group's, so captured and eager work
never share a communicator. NCCL's teardown waits for every CUDA graph
that holds a communicator's work: a group destroyed while a captured
step's graphs live never returns. So the mesh holds the captured steps
made over it (``hold``), and ``shutdown`` frees their graphs before it
destroys the group; a ``HybridMesh`` captures on both of its groups'
graph communicators. JAX's ``multihost.dcn_mesh`` has no
counterpart here: NCCL chooses its own intra- and inter-node topology
(rings and trees over NVLink and the network).
"""

import os
import weakref

import numpy as np
import torch
import torch.distributed as dist

from .multihost import process_local_range


class _RankMean(torch.autograd.Function):
    """The mean over the ranks of ``x``; the backward gives ``g / size``
    and communicates nothing (see the module's docstring)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.size = size
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out / size

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.size, None, None


class DeviceMesh:
    """An ordered tuple of devices in one process. The first is the home
    device, where a caller uploads inputs and gathers results. A device
    may be listed more than once (one card standing for two)."""

    def __init__(self, devices):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError('a DeviceMesh needs at least one device')
        self.devices = devices

    def __len__(self):
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    @property
    def home(self):
        return self.devices[0]

    def __repr__(self):
        return f'DeviceMesh({", ".join(map(str, self.devices))})'

    def describe(self):
        """'4 devices: cuda:0..cuda:3' for consecutive cards, else the
        list."""
        names = [str(d) for d in self.devices]
        n = len(names)
        idx = [d.index for d in self.devices]
        if n > 2 and len({d.type for d in self.devices}) == 1 and \
                None not in idx and idx == list(range(idx[0], idx[0] + n)):
            names = [f'{names[0]}..{names[-1]}']
        return f'{n} device{"s" if n > 1 else ""}: {", ".join(names)}'


def default_mesh(devices=None):
    """The ``DeviceMesh`` over ``devices``, or over every visible card
    (``cuda:0`` .. ``cuda:{device_count - 1}``, as
    ``CUDA_VISIBLE_DEVICES`` shows them) when None; without a card that
    raises: a CPU mesh is made only from an explicit list."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('default_mesh() covers the visible CUDA '
                               'cards and none is available; pass a list '
                               'of devices')
        devices = [f'cuda:{i}' for i in range(torch.cuda.device_count())]
    return DeviceMesh(devices)


class _GroupMesh:
    """What a mesh over the ranks of one process group (the default group
    when ``group`` is None) holds: this rank's device, rank and size, the
    backend, and under NCCL the communicator that captured collectives
    take (``graph_group``: made here unless given, and warmed). Shared by
    ``DataMesh`` and ``ModelMesh``."""

    # the world rank of the group's first rank (``check_replicated``)
    src = 0

    def __init__(self, device, group=None, graph_group=None):
        self.group = group
        if group is not None:
            self.src = dist.get_global_rank(group, 0)
        self.device = torch.device(device)
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.graph_group = None
        self._captured = weakref.WeakSet()
        if self.backend == 'nccl':
            if graph_group is None:
                ranks = None if group is None else \
                    dist.get_process_group_ranks(group)
                graph_group = dist.new_group(ranks, backend='nccl')
            self.graph_group = graph_group
            # the communicator must exist before a capture records it
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=self.graph_group)
            torch.cuda.synchronize(self.device)

    def __repr__(self):
        return (f'{type(self).__name__}(rank {self.rank} of {self.size}, '
                f'{self.backend}, {self.device})')

    @property
    def is_main(self):
        """Whether this rank writes the files and prints the progress."""
        return self.rank == 0

    def hold(self, step):
        """Keep a weak reference to ``step``, a ``CapturedStep`` whose
        graphs may record this mesh's collectives (see ``shutdown``)."""
        self._captured.add(step)

    def release_graphs(self):
        """Free the graphs of every captured step made over this mesh."""
        for step in list(self._captured):
            step.release()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _group(self):
        """The group of a collective issued now: ``graph_group`` while
        the current stream is being captured, else ``group``."""
        if self.graph_group is not None and \
                torch.cuda.is_current_stream_capturing():
            return self.graph_group
        return self.group

    @property
    def capturable(self):
        """Whether the collectives can be captured into a CUDA graph."""
        return self.backend == 'nccl'

    @torch.no_grad()
    def check_replicated(self, tensors, what):
        """Raise unless this rank's ``tensors`` equal the group's first
        rank's, bit for bit (``what`` names them in the message)."""
        tensors = list(tensors)
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        ref = flat.clone()
        dist.broadcast(ref, self.src, group=self.group)
        if not torch.equal(ref, flat):
            raise RuntimeError(
                f'rank {self.rank} of {self!r} holds other {what} than its '
                f'rank 0 ({int((ref != flat).sum())} of {flat.numel()} '
                f'values differ): every rank must start from the same seed '
                f'and the same files')

    def barrier(self):
        if self.backend == 'nccl':
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def _all_gather(self, t, group):
        """Each rank's ``t`` (one shape), in rank order."""
        if self.backend == 'nccl':
            out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype,
                              device=t.device)
            dist.all_gather_into_tensor(out, t, group=group)
            return list(out.unbind(0))
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=group)
        return parts

    def _all_reduce(self, t, group):
        dist.all_reduce(t, group=group)


class DataMesh(_GroupMesh):
    """The 1-D data mesh over the ranks of ``group`` (the default group
    when None); ``device`` is this rank's device. As a step's ``mesh`` it
    is its own data axis and has no model axis (``HybridMesh`` has
    both) and no spatial axis (``parallel.spatial.SpatialMesh``)."""

    model = None
    spatial = None

    @property
    def data(self):
        return self

    def local_rows(self, batch):
        """This rank's rows of a global batch: a tensor, or a tuple of
        them with one leading size."""
        if isinstance(batch, (tuple, list)):
            return type(batch)(self.local_rows(b) for b in batch)
        lo, hi = process_local_range(batch.shape[0], self.rank, self.size)
        return batch[lo:hi]

    def mean(self, x):
        """The mean over the ranks of ``x``, differentiable (above)."""
        return _RankMean.apply(x, self._group(), self.size)

    def stat(self, t):
        """The sum over the ranks of ``t``, detached, as a new tensor."""
        out = t.detach().clone()
        dist.all_reduce(out, group=self._group())
        return out

    @torch.no_grad()
    def sum_(self, tensors):
        """Sum ``tensors`` (one dtype) over the ranks, in place, through
        one flattened bucket."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self._group())
        torch._foreach_copy_(tensors, [
            part.view_as(t) for part, t in zip(
                flat.split([t.numel() for t in tensors]), tensors)])


def stack_channels(parts, blocks=1):
    """The channel concat of the ranks' shards ``parts`` (each [N, blocks
    * c, ...], in rank order), where each shard's channels are ``blocks``
    blocks of its c channels and the whole's are the same blocks of the
    ranks' c each (the s2d head's (dy, dx, class) order, blocks 4)."""
    n, c = parts[0].shape[:2]
    rest = tuple(parts[0].shape[2:])
    whole = torch.stack([p.reshape((n, blocks, c // blocks) + rest)
                         for p in parts], dim=2)
    return whole.reshape((n, c * len(parts)) + rest)


def channel_shard(t, rank, size, blocks=1):
    """Rank ``rank``'s shard of ``t``'s channels as ``stack_channels``
    lays them out (a copy)."""
    n, c = t.shape[:2]
    rest = tuple(t.shape[2:])
    parts = t.reshape((n, blocks, size, c // (blocks * size)) + rest)
    return parts[:, :, rank].reshape((n, c // size) + rest)


class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group, on the group the forward chose (a captured forward's backward
    is captured too)."""

    @staticmethod
    def forward(ctx, x, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        ctx.mesh._all_reduce(grad, ctx.group)
        return grad, None, None


class _Gather(torch.autograd.Function):
    """The model group's channel shards gathered into the whole tensor;
    the backward hands this rank its channels of the (replicated)
    gradient and communicates nothing."""

    @staticmethod
    def forward(ctx, y, mesh, blocks, group):
        ctx.rank, ctx.size, ctx.blocks = mesh.rank, mesh.size, blocks
        return stack_channels(mesh._all_gather(y.contiguous(), group),
                              blocks)

    @staticmethod
    def backward(ctx, grad):
        return (channel_shard(grad, ctx.rank, ctx.size, ctx.blocks), None,
                None, None)


class ModelMesh(_GroupMesh):
    """The model axis of a ``HybridMesh``: the ranks of ``group`` each
    hold a shard of every sharded conv's output channels
    (``parallel/sharding.py``). A sharded layer takes its whole input,
    computes its channels, and gathers them, so every activation between
    layers, and its gradient, is the same on every rank of the group:

    - ``enter(x)`` goes in front of a sharded layer: the identity, whose
      backward sums the gradient over the group (each rank's is the part
      its channels contribute);
    - ``gather(y)`` goes behind it: the ranks' channels concatenated,
      whose backward slices this rank's channels from the gradient and
      communicates nothing.

    A replicated layer (whose output channels do not divide the group)
    takes neither: its input's gradient is whole on every rank already,
    and a sum over the group would make it ``size`` times too large."""

    def enter(self, x):
        return _Enter.apply(x, self, self._group())

    def gather(self, y, blocks=1):
        """The whole of the channel shards ``y`` ([N, blocks * c, ...]),
        ``stack_channels``'s layout."""
        return _Gather.apply(y, self, blocks, self._group())

    def shard(self, t, dim):
        """This rank's equal part of ``t`` along ``dim`` (a view)."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n)

    @torch.no_grad()
    def unshard(self, t, dim):
        """The ranks' parts ``t`` concatenated along ``dim`` (no
        gradient)."""
        return torch.cat(self._all_gather(t.contiguous(), self._group()),
                         dim=dim)


def rank_grid(dp, mp):
    """[dp, mp] array of the world ranks of a (data, model) grid: rank d *
    mp + m at (d, m), as JAX's ``hybrid_mesh`` reshapes its devices, so
    a model group is ``mp`` consecutive ranks (and a (data, spatial) grid's
    spatial group, as JAX's ``spatial_mesh`` reshapes them)."""
    return np.arange(dp * mp).reshape(dp, mp)


def grid_groups(dp, n, what):
    """This rank's (group, graph communicator) on each axis of a (dp, n)
    grid of the world's ranks (``rank_grid``): its data group (the ranks
    of its column) and its group on the second axis (its row). The graph
    communicator is an NCCL group of the same ranks under NCCL, else
    None. ``dist.new_group`` is collective over the whole world, so every
    rank makes every group in the same order, the groups it is not in
    included. ``what`` names the grid in the error of a world of another
    size."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * n != world:
        raise ValueError(f'a ({dp}, {n}) {what} needs {dp * n} ranks; '
                         f'the world has {world}')
    nccl = dist.get_backend() == 'nccl'
    grid = rank_grid(dp, n)
    mine = []
    for groups in (grid.T, grid):
        for ranks in groups.tolist():
            group = dist.new_group(ranks)
            graph = dist.new_group(ranks, backend='nccl') if nccl else None
            if rank in ranks:
                mine.append((group, graph))
    return mine

class HybridMesh:
    """The 2-D (data, model) mesh over the default process group: the
    counterpart of ``patchgan_tpu/parallel/sharding.py``'s
    ``hybrid_mesh``. ``data`` is the ``DataMesh`` over this rank's data
    group (the ranks that hold the same model shard: the batch splits
    over it, the losses average over it, the gradients sum over it);
    ``model`` the ``ModelMesh`` over its model group (the ranks of one
    data rank, whose convs split their output channels), both made by
    ``grid_groups``. A rank's rows of a global batch follow its data rank
    (``local_rows``), not its world rank."""

    def __init__(self, dp, mp, device):
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.backend = dist.get_backend()
        data, model = grid_groups(dp, mp, 'mesh')
        self.data = DataMesh(device, *data)
        self.model = ModelMesh(device, *model)
        self.device = self.data.device
        self.shape = {'data': dp, 'model': mp}

    def __repr__(self):
        return (f'HybridMesh(rank {self.rank} of {self.shape}, '
                f'{self.backend}, {self.device})')

    @property
    def is_main(self):
        return self.rank == 0

    @property
    def capturable(self):
        return self.data.capturable and self.model.capturable

    def local_rows(self, batch):
        """This rank's rows of a global batch: its data rank's."""
        return self.data.local_rows(batch)

    def hold(self, step):
        self.data.hold(step)

    def release_graphs(self):
        self.data.release_graphs()
        self.model.release_graphs()

    def barrier(self):
        if self.backend == 'nccl':
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def torchrun_env():
    """(rank, world size, local rank) from torchrun's environment, or
    None outside it."""
    if 'WORLD_SIZE' not in os.environ:
        return None
    return (int(os.environ.get('RANK', 0)), int(os.environ['WORLD_SIZE']),
            int(os.environ.get('LOCAL_RANK', 0)))


def init_from_env(on_cpu=False, mp=1, sp=1):
    """The ``DataMesh`` of a process that torchrun started (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``):
    gloo over the CPU when ``on_cpu``, else NCCL with this rank on
    ``cuda:LOCAL_RANK``; with ``mp`` > 1 the ``HybridMesh`` of world size
    / ``mp`` data ranks by ``mp`` model ranks, with ``sp`` > 1 the
    ``SpatialMesh`` of world size / ``sp`` data ranks by ``sp`` spatial
    ranks (both at once raise ValueError: neither package has that mesh).
    None outside torchrun: a single process."""
    if mp > 1 and sp > 1:
        raise ValueError(f'a model axis (mp {mp}) and a spatial axis (sp '
                         f'{sp}) at once: no mesh of this package has both')
    env = torchrun_env()
    if env is None:
        return None
    rank, size, local = env
    if on_cpu:
        device, backend, kwargs = torch.device('cpu'), 'gloo', {}
    else:
        if not torch.cuda.is_available():
            raise RuntimeError('a process group on the card needs a CUDA '
                               'GPU and none is available; pass -d cpu')
        device = torch.device('cuda', local)
        torch.cuda.set_device(device)
        backend, kwargs = 'nccl', {'device_id': device}
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method='env://', rank=rank,
                                world_size=size, **kwargs)
    if mp > 1:
        return HybridMesh(size // mp, mp, device)
    if sp > 1:
        from .spatial import SpatialMesh
        return SpatialMesh(size // sp, sp, device)
    return DataMesh(device)


def shutdown(mesh):
    """Destroy the default process group ``init_from_env`` made (and the
    groups a ``HybridMesh`` or a ``SpatialMesh`` made with it), once the
    graphs of the captured steps made over ``mesh``, on every axis, are
    freed: NCCL's teardown waits for them."""
    if mesh is not None and dist.is_initialized():
        mesh.release_graphs()
        dist.destroy_process_group()
