"""Spatial (image-height) parallelism for training: the counterpart of
``patchgan_tpu/parallel/spatial.py``.

The JAX package lays a 2-D ``(data, spatial)`` mesh over its devices,
shards each batch's samples over ``data`` and its image HEIGHT over
``spatial``, replicates the parameters, and lets GSPMD insert the halo
exchanges of the strided convs and turn the instance-norm means and the
loss reductions into collectives. The port runs one process per card and
does explicitly what GSPMD does. A ``SpatialMesh`` is the grid, world rank
``d * sp + s`` at (d, s) as JAX's ``devices[:dp*sp].reshape(dp, sp)``;
each rank holds its data group's samples and a band of ``H / sp`` rows of
every image, and the step takes the band (``SpatialMesh.band``):

- ``SpatialAxis.halo(x, above, below)``: the band with its neighbours'
  edge rows, zeros at the image's edges, so a conv over it gives the
  band's rows of the whole conv (k4/s2/p1: one row each side; the
  discriminator's k4/s1/p1: one above and two below, its output ``H - 1``
  rows). The forward is one all-gather of every rank's edge rows over the
  spatial group (it captures into a CUDA graph under NCCL); the backward
  all-gathers the halo rows' gradients and adds each to its owner's rows.
- ``band_sum(t)``: the sum over the group of a per-band partial (the
  instance-norm statistics, the losses' sums), whose backward passes the
  gradient on unchanged, since every rank computes the same loss from the
  summed value (``_RankMean``'s pattern, for a sum).
- ``gather_band(x)`` / ``split_band(x)``: a level whose rows do not split
  into ``sp`` bands of an even number of rows (the UNet's deep levels) runs
  whole on every rank: the all-gather in, whose backward is a
  reduce-scatter, and the rank's rows out, whose backward zero-pads. Each
  rank's gradient of such a level's weight is then its band's part. (The
  model axis's ``_Gather`` slices in its backward, because its consumers
  are replicated; here that would drop the other bands' parts.)
- The instance norms run the band forms of kernels K1, K1-bwd, K2 and K3
  (``ops/kernels``): statistics out, ``band_sum``, statistics in.
- The losses' per-sample sums and means go through ``band_sum`` before a
  ratio or a division by the global count (``ops/losses.py``); the
  parameters' gradients are summed over every rank of the grid, since the
  parameters are replicated on all ``dp * sp``.

A batch whose height does not split into ``sp`` bands of an even number
of rows (``SpatialMesh.splits``) runs the step with H whole on every rank
of a spatial group, as data parallelism over the data axis: correct, but
not split (the Trainer warns). Which levels of a model run on bands is
the model's rule (``models/unet.py``'s ``gather_level``,
``models/disc.py``'s ``disc_splits``).

The inference engine splits one image's rows over the devices of one
process (``inference/engine.py``'s spatial mode; JAX places the image
with ``P(None, 'data')`` on its mesh). There ``BandThreads.run`` runs one
host thread a device, each through the same band forward on its own band,
and a ``LocalSpatialAxis`` stands for the process group. The threads take
turns, in rank order around a ring: only the thread that holds the turn
runs, so they never contend for the interpreter (threads that issue
kernels at once pass it back and forth at every call, which made a band
forward several times slower than one thread's on the card). An exchange
deposits the rank's tensor, with an event recorded behind the work that
made it, in a slot, and passes the turn on; when the turn comes back
every rank has deposited, and the rank takes the parts: a part on
another device is copied on a side stream of that device that waits for
the part's event alone, and the rank's stream waits for the copy. No
rank waits on the host for another's work, and no device waits for work
its peer queued after the part (the ranks are a step apart around the
ring), so the devices run their bands at once. The slots alternate
between two sets, since rank 0 deposits its next part before the last
rank has taken this one. ``all_reduce`` deposits a copy of its tensor,
which it then overwrites in place, and adds the parts in rank order on
every device, so every device holds the same bits. A device listed twice
(one card standing for two) has two threads on one stream, and a part on
the same device is the deposited tensor itself.
"""

import contextlib
import functools
import queue
import threading
import weakref

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import DataMesh, _GroupMesh, grid_groups, rank_grid

SPATIAL_AXIS = 'spatial'


class _Halo(torch.autograd.Function):
    """The band with ``above`` rows of the rank above and ``below`` rows of
    the rank below (zeros at the image's edges); the backward adds the halo
    rows' gradients to their owners' rows."""

    @staticmethod
    def forward(ctx, x, axis, above, below, group):
        ctx.axis, ctx.above, ctx.below, ctx.group = axis, above, below, group
        h = x.shape[2]
        if h < max(above, below):
            raise ValueError(f'a band of {h} rows cannot lend a halo of '
                             f'{above} above and {below} below')
        ctx.h = h
        s, n = axis.rank, axis.size
        edges = torch.cat([x[:, :, :below], x[:, :, h - above:]], dim=2)
        parts = axis.all_gather(edges.contiguous(), group)
        shape = list(x.shape)
        shape[2] = above
        top = parts[s - 1][:, :, below:] if s > 0 else x.new_zeros(shape)
        shape[2] = below
        bottom = parts[s + 1][:, :, :below] if s < n - 1 else \
            x.new_zeros(shape)
        return torch.cat([top, x, bottom], dim=2)

    @staticmethod
    def backward(ctx, g):
        axis, above, below, h = ctx.axis, ctx.above, ctx.below, ctx.h
        s, n = axis.rank, axis.size
        send = torch.cat([g[:, :, :above], g[:, :, above + h:]], dim=2)
        parts = axis.all_gather(send.contiguous(), ctx.group)
        dx = g[:, :, above:above + h].clone()
        if s > 0:        # the rank above's lower halo is this band's top
            dx[:, :, :below] += parts[s - 1][:, :, above:]
        if s < n - 1:    # the rank below's upper halo is this band's bottom
            dx[:, :, h - above:] += parts[s + 1][:, :, :above]
        return dx, None, None, None, None


class _BandSum(torch.autograd.Function):
    """The sum over the spatial group; the backward passes the gradient on
    and communicates nothing."""

    @staticmethod
    def forward(ctx, t, axis, group):
        out = t.detach().clone()
        axis.all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherBand(torch.autograd.Function):
    """The group's bands stacked into the whole height; the backward sums
    the gradient over the group and hands each rank its rows (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return torch.cat(axis.all_gather(x.contiguous(), group), dim=2)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.reduce_scatter_rows(grad, ctx.group), None, None


class _SplitRows(torch.autograd.Function):
    """Rows [lo, hi) of a tensor every rank holds whole; the backward puts
    the gradient back in place with zeros around it."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.pad = (0, 0, lo, x.shape[2] - hi)
        return x[:, :, lo:hi].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return F.pad(grad, ctx.pad), None, None


class SpatialAxis(_GroupMesh):
    """The spatial axis of a ``SpatialMesh``: the ranks of ``group`` each
    hold an equal band of every image's rows, in rank order."""

    # the group a collective made now takes: the graph communicator under
    # a capture (a band op's backward takes the one its forward took), and
    # the collectives the band kernels' Functions make on it
    group_now = _GroupMesh._group
    all_gather = _GroupMesh._all_gather
    all_reduce = _GroupMesh._all_reduce

    def rows(self, h):
        """(lo, hi) of this rank's band of ``h`` rows."""
        if h % self.size:
            raise ValueError(f'{h} rows do not split into {self.size} '
                             f'equal bands')
        n = h // self.size
        return self.rank * n, (self.rank + 1) * n

    def band(self, t):
        """This rank's band of ``t``'s rows (dim 2), contiguous."""
        lo, hi = self.rows(t.shape[2])
        return t[:, :, lo:hi].contiguous()

    def halo(self, x, above=1, below=1):
        return _Halo.apply(x, self, above, below, self._group())

    def band_sum(self, t):
        """The sum over the group of the per-band partial ``t``,
        differentiable (the module's docstring)."""
        return _BandSum.apply(t, self, self._group())

    def stat(self, t):
        """The sum over the group of ``t``, detached, as a new tensor."""
        out = t.detach().clone()
        self.all_reduce(out, self._group())
        return out

    def gather_band(self, x):
        return _GatherBand.apply(x, self, self._group())

    def split_band(self, x):
        return _SplitRows.apply(x, *self.rows(x.shape[2]))

    def split_rows(self, x, lo, hi):
        """Rows [lo, hi) of ``x``, which every rank holds whole; the
        backward zero-pads."""
        return _SplitRows.apply(x, lo, hi)

    def reduce_scatter_rows(self, grad, group):
        """This rank's band of the sum over the group of ``grad`` (the
        whole height, on every rank)."""
        n, c, h, w = grad.shape
        if self.backend == 'nccl':
            parts = grad.reshape(n, c, self.size, h // self.size, w) \
                .permute(2, 0, 1, 3, 4).contiguous()
            out = grad.new_empty((n, c, h // self.size, w))
            dist.reduce_scatter_tensor(out, parts, group=group)
            return out
        total = grad.contiguous().clone()
        self._all_reduce(total, group)
        return self.band(total)


def even_bands(h, n):
    """Whether ``h`` rows split into ``n`` bands of an even number of
    rows (else a spatial mesh keeps H whole)."""
    return h % (2 * n) == 0


class _Meeting:
    """Where the threads of one ``BandThreads.run`` take turns: a gate a
    rank (a thread runs only while it holds the turn, ``take``; ``round``
    passes it to the next rank and waits until it comes back), two sets of
    slots a rank, and a broken flag that a failing rank sets (``abort``)
    and a wait of more than ``timeout`` seconds sets too."""

    def __init__(self, size, timeout):
        self.size, self.timeout = size, timeout
        self.slots = ([None] * size, [None] * size)
        self._gates = [threading.Semaphore(0) for _ in range(size)]
        self.broken = False

    def take(self, rank):
        """Wait for the turn; raise ``threading.BrokenBarrierError`` when
        the meeting is broken."""
        if not self._gates[rank].acquire(timeout=self.timeout):
            self.abort()
        if self.broken:
            raise threading.BrokenBarrierError

    def pass_turn(self, rank):
        self._gates[(rank + 1) % self.size].release()

    def round(self, rank):
        """Pass the turn on and wait for it: every other rank has run up
        to its next ``round`` meanwhile."""
        self.pass_turn(rank)
        self.take(rank)

    def abort(self):
        self.broken = True
        for gate in self._gates:
            gate.release()


class LocalSpatialAxis(SpatialAxis):
    """The spatial axis over the devices of one process: rank ``rank`` of
    ``size`` is the thread that drives ``devices[rank]``, and the
    collectives are copies between devices through ``meeting`` (the
    module's docstring). Everything else is ``SpatialAxis``'s."""

    backend = 'threads'
    group = graph_group = None

    def __init__(self, rank, devices, meeting):
        self.rank, self.size = rank, len(devices)
        self.device = devices[rank]
        self._meeting = meeting
        self._exchanges = 0
        self._sides = {}

    def _exchange(self, t):
        """Every rank's ``t``, in rank order, on this rank's device."""
        meeting, n = self._meeting, self._exchanges
        slots = meeting.slots[n % 2]
        self._exchanges += 1
        made = None
        if t.is_cuda:
            made = torch.cuda.Event()
            made.record(torch.cuda.current_stream(t.device))
        slots[self.rank] = n, t, made
        meeting.round(self.rank)
        for r, slot in enumerate(slots):
            if slot is None or slot[0] != n:
                raise RuntimeError(f'rank {r} of the {self.size}-device '
                                   f'spatial axis did not reach exchange '
                                   f'{n}: it ended or ran other exchanges')
        return [self._take(part, made) for _, part, made in slots]

    def _take(self, part, made):
        """``part`` on this rank's device: itself on the same device, else
        a copy queued on a side stream of its device that waits for the
        event recorded behind the work that made it (not for what its
        owner queued since), and that this rank's stream waits for."""
        if part.device == self.device:
            return part
        if made is None:                    # a host part
            return part.to(self.device)
        side = self._sides.get(part.device)
        if side is None:
            side = self._sides[part.device] = torch.cuda.Stream(part.device)
        side.wait_event(made)
        with torch.cuda.stream(side):
            out = part.to(self.device, non_blocking=True)
        part.record_stream(side)
        return out

    def _all_gather(self, t, group):
        return self._exchange(t)

    def _all_reduce(self, t, group):
        t.copy_(functools.reduce(torch.add, self._exchange(t.clone())))

    all_gather, all_reduce = _all_gather, _all_reduce


class LocalSpatialMesh:
    """What ``UNet.forward(..., mesh=)`` takes on one rank of a
    ``LocalSpatialAxis``: the spatial axis alone, no data or model
    axis."""

    data = model = None

    def __init__(self, spatial):
        self.spatial = spatial
        self.device = spatial.device


# seconds a rank waits for its turn before the axis breaks: a rank that
# hangs, not one that fails (that one breaks the meeting at once)
BAND_TIMEOUT_S = 300


def _serve(jobs):
    while True:
        job = jobs.get()
        if job is None:
            return
        job()
        del job     # the last job must not keep its caller alive


def _stop(queues, threads):
    """End the threads of a ``BandThreads`` (when it is collected, and at
    exit, before the interpreter drops its daemon threads)."""
    for jobs in queues:
        jobs.put(None)
    for t in threads:
        if t is not threading.current_thread():
            t.join()


class BandThreads:
    """``size`` host threads that live as long as this object, thread r
    running rank r of every ``run``: what PyTorch keeps a thread (cuDNN's
    handles and execution plans) then outlives a call, where new threads
    would rebuild every cuDNN plan of the band forward at every call. One
    call at a time (a lock); ``idle`` says whether no thread is running
    one."""

    def __init__(self, size):
        self.size = size
        self._lock = threading.Lock()
        self._queues = [queue.SimpleQueue() for _ in range(size)]
        self._running = [False] * size
        threads = [threading.Thread(target=_serve, args=(jobs,), daemon=True,
                                    name=f'spatial-band-{r}')
                   for r, jobs in enumerate(self._queues)]
        for t in threads:
            t.start()
        weakref.finalize(self, _stop, self._queues, threads)

    @property
    def idle(self):
        return not any(self._running)

    def run(self, devices, fn, timeout=BAND_TIMEOUT_S):
        """``fn(mesh)`` on every device of ``devices`` (one a thread), rank
        r on thread r with ``devices[r]`` current, ``mesh`` rank r's
        ``LocalSpatialMesh``, the ranks taking turns (the module's
        docstring); the results in rank order. A rank that raises breaks
        the meeting, so no other waits for it; once every rank has ended
        the first rank's own error is raised here (or, when every rank
        only saw the meeting break, the first of those)."""
        devices = [torch.device(d) for d in devices]
        if len(devices) != self.size:
            raise ValueError(f'{self.size} band threads for '
                             f'{len(devices)} devices')
        meeting = _Meeting(self.size, timeout)
        results, errors = [None] * self.size, [None] * self.size
        done = threading.Semaphore(0)

        def rank(r):
            self._running[r] = True
            device = devices[r]
            try:
                if r:
                    meeting.take(r)
                with (torch.cuda.device(device) if device.type == 'cuda'
                      else contextlib.nullcontext()):
                    results[r] = fn(LocalSpatialMesh(LocalSpatialAxis(
                        r, devices, meeting)))
            except BaseException as e:
                errors[r] = e
                meeting.abort()
            finally:
                meeting.pass_turn(r)
                self._running[r] = False
                done.release()

        with self._lock:
            for r, jobs in enumerate(self._queues):
                jobs.put(functools.partial(rank, r))
            for _ in range(self.size):
                done.acquire()
        own = [e for e in errors if e is not None and
               not isinstance(e, threading.BrokenBarrierError)]
        if own:
            raise own[0]
        broken = [e for e in errors if e is not None]
        if broken:
            raise RuntimeError(f'a rank of the {self.size}-device spatial '
                               f'axis did not reach an exchange within '
                               f'{timeout} s') from broken[0]
        return results


class SpatialMesh:
    """The 2-D (data, spatial) mesh over the default process group: the
    counterpart of JAX's ``spatial_mesh``. ``data`` is the ``DataMesh`` over
    this rank's data group (the ranks that hold the same band: the batch
    splits over it), ``spatial`` the ``SpatialAxis`` over its spatial group
    (the ranks of one data rank, whose bands make up the image), ``grid``
    a ``DataMesh`` over every rank (the gradient buckets, the checks of
    replication, the class weights' sums). The groups are
    ``grid_groups``'s, as ``HybridMesh``'s are.

    As a step's ``mesh`` (``train/steps.py``) it is also the losses'
    reducer: ``mean`` over the data axis, ``stat`` and ``sum_`` over the
    grid, ``spatial`` for the band sums."""

    model = None

    def __init__(self, dp, sp, device):
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.backend = dist.get_backend()
        data, spatial = grid_groups(dp, sp, 'spatial mesh')
        self.data = DataMesh(device, *data)
        self.spatial = SpatialAxis(device, *spatial)
        self.grid = DataMesh(device)
        self.device = self.data.device
        self.shape = {'data': dp, SPATIAL_AXIS: sp}

    def __repr__(self):
        return (f'SpatialMesh(rank {self.rank} of {self.shape}, '
                f'{self.backend}, {self.device})')

    def describe(self):
        return (f'{self.shape["data"]} x {self.shape[SPATIAL_AXIS]} ranks '
                f'(data x spatial)')

    @property
    def is_main(self):
        return self.rank == 0

    @property
    def capturable(self):
        return self.backend == 'nccl'

    def splits(self, h):
        """Whether a batch of height ``h`` splits into bands of an even
        number of rows (else the step keeps H whole)."""
        return even_bands(h, self.spatial.size)

    def local_rows(self, batch):
        """This rank's rows of a global batch (its data rank's), whole in
        H: what the step takes."""
        return self.data.local_rows(batch)

    def band(self, batch):
        """This rank's band of a tensor's rows, or of each of a tuple's."""
        if isinstance(batch, (tuple, list)):
            return type(batch)(self.band(b) for b in batch)
        return self.spatial.band(batch)

    def mean(self, x):
        """The mean over the data ranks (``DataMesh.mean``)."""
        return self.data.mean(x)

    def stat(self, t):
        """The sum over every rank of ``t``, detached."""
        return self.grid.stat(t)

    def sum_(self, tensors):
        """Sum ``tensors`` over every rank in place (the gradients of the
        replicated parameters)."""
        self.grid.sum_(tensors)

    def check_replicated(self, tensors, what):
        self.grid.check_replicated(tensors, what)

    def hold(self, step):
        self.grid.hold(step)

    def release_graphs(self):
        for axis in (self.grid, self.data, self.spatial):
            axis.release_graphs()

    def barrier(self):
        self.grid.barrier()


def spatial_mesh(dp, sp, device):
    """The (dp x sp) ``SpatialMesh`` over the default process group, this
    rank on ``device``."""
    return SpatialMesh(dp, sp, device)


def shard_batch_spatial(batch, mesh):
    """This rank's rows of N and its band of H of a global NCHW batch (a
    tensor or a tuple of them; JAX ``shard_batch_spatial``)."""
    return mesh.band(mesh.local_rows(batch))


@torch.no_grad()
def replicate_spatial(tensors, mesh):
    """Rank 0's values of ``tensors`` (parameters, optimizer state) on
    every rank of the grid, in place; returns them."""
    tensors = list(tensors)
    for t in tensors:
        dist.broadcast(t, 0)
    return tensors


__all__ = ['SPATIAL_AXIS', 'BandThreads', 'LocalSpatialAxis', 'LocalSpatialMesh',
           'SpatialAxis', 'SpatialMesh', 'even_bands', 'rank_grid',
           'replicate_spatial', 'shard_batch_spatial',
           'spatial_mesh']
