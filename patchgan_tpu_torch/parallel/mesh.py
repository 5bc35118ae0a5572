"""Device meshes: the counterpart of ``patchgan_tpu/parallel/mesh.py``.

Two meshes stand for the JAX package's one. ``DeviceMesh`` is the 1-D
mesh over the cards of one process (``default_mesh``): the inference
engine keeps a replica of its weights on each device of it (the
counterpart of ``replicate``) and splits each bucket of tiles over them
(the counterpart of ``shard_batch``). ``DataMesh`` is data parallelism
across processes, described below.

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
- ``check_replicated(tensors, what)``: rank 0's values broadcast and
  compared with every rank's own; a rank that differs raises.

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
destroys the group. JAX's ``multihost.dcn_mesh`` has no
counterpart here: NCCL chooses its own intra- and inter-node topology
(rings and trees over NVLink and the network).
"""

import os
import weakref

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


class DataMesh:
    """The 1-D data mesh over the ranks of ``group`` (the default group
    when None); ``device`` is this rank's device."""

    def __init__(self, device, group=None):
        self.group = group
        self.device = torch.device(device)
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.graph_group = None
        self._captured = weakref.WeakSet()
        if self.backend == 'nccl':
            ranks = None if group is None else \
                dist.get_process_group_ranks(group)
            self.graph_group = dist.new_group(ranks, backend='nccl')
            # the communicator must exist before a capture records it
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=self.graph_group)
            torch.cuda.synchronize(self.device)

    def __repr__(self):
        return (f'DataMesh(rank {self.rank} of {self.size}, '
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

    @torch.no_grad()
    def check_replicated(self, tensors, what):
        """Raise unless this rank's ``tensors`` equal rank 0's, bit for
        bit (``what`` names them in the message)."""
        tensors = list(tensors)
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        ref = flat.clone()
        dist.broadcast(ref, 0, group=self.group)
        if not torch.equal(ref, flat):
            raise RuntimeError(
                f'rank {self.rank} holds other {what} than rank 0 '
                f'({int((ref != flat).sum())} of {flat.numel()} values '
                f'differ): every rank must start from the same seed and '
                f'the same files')

    def barrier(self):
        if self.backend == 'nccl':
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def torchrun_env():
    """(rank, world size, local rank) from torchrun's environment, or
    None outside it."""
    if 'WORLD_SIZE' not in os.environ:
        return None
    return (int(os.environ.get('RANK', 0)), int(os.environ['WORLD_SIZE']),
            int(os.environ.get('LOCAL_RANK', 0)))


def init_from_env(on_cpu=False):
    """The ``DataMesh`` of a process that torchrun started (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``):
    gloo over the CPU when ``on_cpu``, else NCCL with this rank on
    ``cuda:LOCAL_RANK``. None outside torchrun: a single process."""
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
    return DataMesh(device)


def shutdown(mesh):
    """Destroy the default process group ``init_from_env`` made, once the
    graphs of the captured steps made over ``mesh`` are freed: NCCL's
    teardown waits for them."""
    if mesh is not None and dist.is_initialized():
        mesh.release_graphs()
        dist.destroy_process_group()
