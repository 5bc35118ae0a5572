"""Training runtime: the epoch loop, LR schedules, checkpoints and resume.

Port of ``patchgan_tpu/train/trainer.py``: the class attributes
(``:71-97``), ``batch()``, ``train()`` with the LR fast-forward on
resume, exponential decay and plateau schedules, ``_run_epoch`` with the
losses fetched one step late (``:478-528``), ``save`` / ``load`` /
``load_last_checkpoint`` (npz epoch files with torch state_dict keys,
which the JAX Trainer reads and writes too), ``load_transfer_checkpoints``,
``freeze_generator`` / ``accumulate_steps`` (``:91-97, 154-160``), which,
as in the JAX Trainer, take effect when ``train()`` rebuilds the
optimizers, ``neptune_config`` (a dict-like whose metric keys hold lists,
``:329-333, 392-403, 435-449``) and ``profile_dir`` (a profiler trace of
the first train epoch, ``:420-425``).

Exact resume (``:336-386, 455-529, 543-647``): ``save_optimizer_state``
writes ``training_state_ep_###.pt`` beside each epoch's npz files (both
models, both optimizers' moments, step counts, learning rates and
accumulation windows, the dropout generator's state and the step count),
which ``load_last_checkpoint`` finds and ``train()`` restores once it has
rebuilt the optimizers. ``save_every_steps = N`` writes the same state
every N train batches into one of two slots,
``training_state_step_{a,b}.pt``, then ``step_state_torch.json`` naming
it (epoch, batches done, the loader iteration the epoch consumes): the
metadata is written last and never names the slot being written, so a
kill at any point leaves a consistent pair. On resume the loader replays
its order (``fast_forward``) and leaves out the trained batches
(``skip_next``), so the run continues bit for bit.
``checkpoint_format = 'orbax'`` (JAX ``:82-83, 346-356, 471-473,
555-562, 594-599, 677-683``) writes the same state through the async
store of ``utils/orbax_ckpt.py`` (``torch.distributed.checkpoint``):
``training_state_ep_###.dcp/`` per save, whose write goes on while the
training does, and ``training_state_step_{a,b}.dcp/`` as the rolling
slots, each waited for before the metadata names it; ``train()`` waits
for the last save before it returns. ``load_last_checkpoint`` takes the
last epoch's ``.dcp`` directory before its ``.pt`` file, whatever the
format, and restores it in place. The file names are not the JAX
Trainer's (``.msgpack``, ``.orbax``, ``step_state.json``): neither
package reads the other's exact-resume files, and both resume each
other's folders from the epoch npz files.

The train step on the card is the captured one (``train/graph.py``),
the counterpart of the JAX Trainer's jitted step, unless
``PATCHGAN_CUDA_GRAPH`` is off, 0 or false when the Trainer is built;
CPU batches take the eager step. The steps are built once per optimizer
set and loss settings and kept, as the JAX Trainer's ``_get_step`` keeps
its jitted steps (``:173-219``); ``_make_optimizers`` drops them. The per-epoch LR write,
``_restore_training_state`` and ``load`` copy into the tensors a
captured step reads, so none of them recaptures.

``generator`` and ``discriminator`` are the port's ``nn.Module``s with
fp32 parameters; they compute in their own ``dtype``. Batches are NCHW
tensors (or numpy arrays), moved to the models' device. Each batch runs
the space-to-depth boundary form (``ops/s2d.py``) when ``PATCHGAN_S2D``
selects it and its H and W are even (``:232-251``); the checkpoints are
the same in both forms.

Data parallelism (``mesh=``, a ``parallel.mesh.DataMesh``; JAX
``Trainer(mesh=...)``): every rank runs this Trainer on its rows of each
global batch (the loader's ``process_index`` / ``process_count``), and
its steps are the data-parallel ones (``train/steps.py``), so the
replicas stay equal. ``train()`` first checks that every rank holds rank
0's weights (the same seed, the same loaded files). Only rank 0 writes
the epoch files, the exact-resume state and its metadata, and every
rank waits at a barrier after each write (after rank 0's ``wait`` for
the async store's rolling save and at the end of ``train()``); every
rank reads them on resume, at any world size. The losses a step reports
are the global batch's on every rank, so the plateau schedule reads the
same validation means everywhere.
Rank 0 alone prints the progress, profiles and reports to
``neptune_config``. Under gloo on the card the step runs eagerly (gloo
cannot be captured); ``PATCHGAN_CUDA_GRAPH=on`` given explicitly then
raises.

The layout (``train/auto_layout.py``; JAX ``_auto_layout`` and
``_shadow_params``, ``:193-209, 253-281``): where ``PATCHGAN_AUTO_LAYOUT``
is on (the default: PERF.md), the Trainer puts both models' parameters
into ``torch.channels_last`` when it is built, and its steps run in it
(``layout='channels_last'``); with a generator computing in another dtype
than its fp32 masters and ``PATCHGAN_SHADOW_PARAMS`` on, the train step
carries the generator's shadow, which ``load``, ``_restore_training_state``
and ``load_transfer_checkpoints`` re-derive after they write the masters.
The forms without a channels_last path (``PATCHGAN_S2D`` on, any mesh)
keep NCHW and warn once. The epoch files hold the same keys and C-order
bytes in either layout, and every store resumes in either.

Spatial parallelism (``mesh=``, a ``parallel.spatial.SpatialMesh``; JAX
``Trainer(mesh=spatial_mesh(...))``): the loader gives each rank its data
group's rows and the step keeps the rank's band of them (JAX
``place_batch``); the checks, the writes and the barriers are the grid's
as above. The step runs the plain form whatever ``PATCHGAN_S2D`` says, as
the JAX Trainer does on a spatial mesh. A batch whose height does not
split into bands of an even number of rows runs with H whole on every
rank of a spatial group, and the Trainer warns once.
"""

import json
import os
import re
import time
import warnings
from collections import defaultdict

import numpy as np
import torch
import tqdm

from ..ops.s2d import s2d_enabled
from ..utils import checkpoint as ckpt
from ..utils import orbax_ckpt
from ..utils.profiling import maybe_trace
from ..utils.transfer import load_transfer_data
from .auto_layout import (LAYOUT, auto_layout_enabled, refresh_shadows,
                          shadow_params_enabled, to_layout, warn_once)
from .graph import CapturedStep, cuda_graph_enabled, graph_flag_given
from .schedulers import (ConstantLR, ExponentialDecay, ReduceLROnPlateau,
                         resume_fast_forward)
from .steps import (LOSS_KEYS, make_eval_step, make_optimizer,
                    make_train_step, trainable_params)

STEP_META = 'step_state_torch.json'


class Trainer:
    '''Owns the G+D step, the epoch loop, and checkpoint save/resume.'''

    seg_alpha = 200
    loss_type = 'tversky'
    tversky_beta = 0.75
    tversky_gamma = 0.75
    bce_weighting = 'complement'

    neptune_config = None  # e.g. a neptune run: run[key] = value for
    #                        parameters, run[key].append(v) for metrics
    compute_iou = False
    profile_dir = None     # profiler trace of the first train epoch
    save_optimizer_state = False   # training_state_ep_###.pt (or .dcp/)
    #                                per save
    checkpoint_format = 'msgpack'  # exact-resume store: 'msgpack' (torch
    #                                files) | 'orbax' (async, utils/orbax_ckpt)
    save_every_steps = None  # rolling exact-resume state every N batches
    adam_mu_dtype = None   # torch.bfloat16 stores Adam's first moment
    freeze_generator = ()  # JAX path prefixes to freeze, e.g. ('enc',)
    accumulate_steps = 1   # apply the update every N batches on the
    #                        running mean of their gradients

    def __init__(self, generator, discriminator, savefolder, device=None,
                 seed=0, mesh=None):
        '''savefolder is created if missing. ``device`` defaults to the
        generator's; ``seed`` seeds the dropout generator on it; ``mesh``
        makes the training data-parallel (see the module's docstring).'''
        if device is None:
            device = next(generator.parameters()).device
        self.device = torch.device(device)
        self.generator = generator.to(self.device)
        self.discriminator = discriminator.to(self.device)
        self.generator.dropout_generator = torch.Generator(
            device=self.device).manual_seed(seed)
        if savefolder[-1] != '/':
            savefolder += '/'
        self.savefolder = savefolder
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        os.makedirs(savefolder, exist_ok=True)
        self.seed = seed
        self.start = 1
        self.step = 0   # train batches run, carried by exact resume
        self._pending_training_state = None
        self._resume_skip_batches = 0
        self._resume_skip_delegated = False
        self._resume_loader_epoch = None
        self._step_slot = None
        self._scheds = None   # train()'s LR schedules, saved with the state
        self._step_cache = None   # (settings, steps, forms) of _steps()
        self._warned_whole = False   # _place_batch's warning, once
        self._cuda_graph = cuda_graph_enabled()
        if mesh is not None and not mesh.capturable and self._cuda_graph:
            if self.device.type == 'cuda' and graph_flag_given():
                raise ValueError(
                    f"PATCHGAN_CUDA_GRAPH=on: a {mesh.backend} process "
                    f"group cannot be captured into a CUDA graph")
            self._cuda_graph = False
        self.layout = self._pick_layout()
        if self.layout is not None:
            # before any optimizer or step holds the tensors
            to_layout((self.generator, self.discriminator), layout=self.layout)
        self.shadow_dtype = self.generator.dtype if (
            self.layout is not None and shadow_params_enabled()
            and self.generator.dtype != torch.float32) else None
        self._make_optimizers(1e-3, 1e-3)

    def _pick_layout(self):
        """The train state's layout (JAX ``_auto_layout``): channels_last
        where ``PATCHGAN_AUTO_LAYOUT`` is on, NCHW where it is off and, with
        a warning once, on the forms that have no channels_last path yet."""
        if not auto_layout_enabled():
            return None
        missing = 'a mesh' if self.mesh is not None else \
            'PATCHGAN_S2D=on' if s2d_enabled() else None
        if missing is not None:
            warn_once(('layout', missing),
                      f"PATCHGAN_AUTO_LAYOUT: {missing} has no channels_last "
                      f"path yet (ROADMAP.md, queue 1); the Trainer keeps "
                      f"NCHW")
            return None
        return LAYOUT

    def _make_optimizers(self, gen_lr, dsc_lr):
        """Both optimizers, accumulating in lockstep; the generator's over
        the parameters ``freeze_generator`` leaves trainable; the steps
        hold the others constant."""
        every_k = self.accumulate_steps or 1
        self._step_cache = None   # its steps update the old optimizers
        self.gen_opt = make_optimizer(
            trainable_params(self.generator, tuple(self.freeze_generator)),
            gen_lr, mu_dtype=self.adam_mu_dtype, every_k=every_k)
        self.disc_opt = make_optimizer(self.discriminator.parameters(),
                                       dsc_lr, mu_dtype=self.adam_mu_dtype,
                                       every_k=every_k)

    def _use_s2d(self, x):
        """The s2d form for an NCHW batch: ``PATCHGAN_S2D`` on, even H
        and W (the 2x2 block grid), and no spatial axis (JAX
        ``trainer.py:237-245``)."""
        if getattr(self.mesh, 'spatial', None) is not None or \
                self.layout is not None:
            return False
        return s2d_enabled() and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0

    def _steps(self):
        """(train step, eval step), each running a batch in the form
        ``_use_s2d`` picks for it; built at first use and kept while the
        optimizers and the loss settings stay. The train step is the
        captured one unless ``PATCHGAN_CUDA_GRAPH`` said off when the
        Trainer was built."""
        loss_kwargs = dict(loss_type=self.loss_type,
                           seg_alpha=self.seg_alpha,
                           tversky_beta=self.tversky_beta,
                           tversky_gamma=self.tversky_gamma,
                           bce_weighting=self.bce_weighting)
        settings = (tuple(loss_kwargs.values()), self.compute_iou)
        if self._step_cache is not None and self._step_cache[0] == settings:
            return self._step_cache[1]
        forms = {}
        # the closures hold what they use, not the Trainer: a Trainer that
        # is dropped frees its models at once, with no cycle to collect
        gen, disc = self.generator, self.discriminator
        gen_opt, disc_opt = self.gen_opt, self.disc_opt
        use_s2d, compute_iou = self._use_s2d, self.compute_iou
        cuda_graph, mesh = self._cuda_graph, self.mesh
        layout, shadow_dtype = self.layout, self.shadow_dtype

        def form(x):
            s2d = use_s2d(x)
            if s2d not in forms:
                forms[s2d] = (
                    make_train_step(gen, disc, gen_opt, disc_opt, s2d=s2d,
                                    graph=cuda_graph, mesh=mesh,
                                    layout=layout, shadow_dtype=shadow_dtype,
                                    **loss_kwargs),
                    make_eval_step(gen, disc, compute_iou=compute_iou,
                                   s2d=s2d, mesh=mesh, layout=layout,
                                   **loss_kwargs))
            return forms[s2d]

        steps = (lambda x, y: form(x)[0](x, y),
                 lambda x, y: form(x)[1](x, y))
        self._step_cache = (settings, steps, forms)
        return steps

    def _refresh_shadows(self):
        """Re-derive the train steps' shadows from the masters, after a
        write to them outside a step; in place, so a captured step reads
        the new values."""
        forms = self._step_cache[2] if self._step_cache else {}
        for train_step, _ in forms.values():
            if train_step.shadows is not None:
                refresh_shadows(train_step.shadows, self.generator)

    def graph_counts(self):
        """(eager steps, captures, replays) of the current captured train
        steps, both forms; zeros for the eager step."""
        forms = self._step_cache[2] if self._step_cache else {}
        steps = [t for t, _ in forms.values() if isinstance(t, CapturedStep)]
        return tuple(sum(getattr(s, k) for s in steps)
                     for k in ('eager_steps', 'captures', 'replays'))

    def _place_batch(self, x, y):
        def place(a):
            if not torch.is_tensor(a):
                a = torch.from_numpy(np.asarray(a))
            return a.to(self.device, non_blocking=True)
        mesh = self.mesh
        if getattr(mesh, 'spatial', None) is not None and \
                not mesh.splits(x.shape[2]) and not self._warned_whole:
            self._warned_whole = True
            warnings.warn(
                f"spatial mesh {mesh.describe()}: images {x.shape[2]} rows "
                f"high do not split into {mesh.spatial.size} bands of an "
                f"even number of rows; the step keeps H whole on every rank "
                f"(correct, but not split)", stacklevel=3)
        return place(x), place(y)

    def batch(self, x, y, train=False):
        '''One G+D step (train=True) or loss evaluation (train=False) on
        one NCHW batch; the reference's dict of Python floats.'''
        train_step, eval_step = self._steps()
        x, y = self._place_batch(x, y)
        losses = (train_step if train else eval_step)(x, y)
        self.step += bool(train)
        return {k: float(v) for k, v in losses.items()}

    def train(self, train_data, val_data, epochs, dsc_learning_rate=1.e-3,
              gen_learning_rate=1.e-3, save_freq=10, lr_decay=None,
              decay_freq=5, reduce_on_plateau=False):
        '''The epoch loop from ``self.start`` to ``epochs``; returns the
        per-epoch mean (G, D) training losses. A resumed run starts from
        the fast-forwarded LR; Adam starts afresh each call, as in the
        reference, unless ``load_last_checkpoint`` found exact-resume
        state, which also carries the LR schedules on from where they
        were; an accumulator carries across the call's epochs.'''
        if (lr_decay is not None) and not reduce_on_plateau:
            gen_lr = resume_fast_forward(gen_learning_rate, lr_decay,
                                         self.start, decay_freq)
            dsc_lr = resume_fast_forward(dsc_learning_rate, lr_decay,
                                         self.start, decay_freq)
        else:
            gen_lr, dsc_lr = gen_learning_rate, dsc_learning_rate
        neptune = self.neptune_config if self.is_main else None
        if neptune is not None:
            neptune['model/parameters/gen_learning_rate'] = gen_lr
            neptune['model/parameters/dsc_learning_rate'] = dsc_lr
            neptune['model/parameters/start'] = self.start
            neptune['model/parameters/n_epochs'] = epochs
        self._make_optimizers(gen_lr, dsc_lr)

        if reduce_on_plateau:
            gen_sched = ReduceLROnPlateau(gen_lr)
            dsc_sched = ReduceLROnPlateau(dsc_lr)
            if neptune is not None:
                neptune['model/parameters/scheduler'] = 'ReduceLROnPlateau'
        elif lr_decay is not None:
            gen_sched = ExponentialDecay(gen_lr, lr_decay, decay_freq)
            dsc_sched = ExponentialDecay(dsc_lr, lr_decay, decay_freq)
            if neptune is not None:
                neptune['model/parameters/scheduler'] = 'ExponentialLR'
                neptune['model/parameters/decay_freq'] = decay_freq
                neptune['model/parameters/lr_decay'] = lr_decay
        else:
            gen_sched, dsc_sched = ConstantLR(gen_lr), ConstantLR(dsc_lr)
        self._scheds = gen_sched, dsc_sched
        if self._pending_training_state is not None:
            self._restore_training_state(self._pending_training_state)
            self._pending_training_state = None
        self._resume_loader(train_data)
        if self.mesh is not None:
            on_card = self.device.type == 'cuda'
            how = 'captured' if self._cuda_graph and on_card else 'eager'
            if on_card and not self.mesh.capturable:
                how += f' (a {self.mesh.backend} group cannot be captured)'
            if getattr(self.mesh, 'spatial', None) is not None:
                self._say(f"Spatial parallel: {self.mesh.describe()} "
                          f"({self.mesh.backend}), the step {how}")
            else:
                self._say(f"Data parallel: {self.mesh.size} ranks "
                          f"({self.mesh.backend}), the step {how}")
            self.mesh.check_replicated(
                list(self.generator.parameters())
                + list(self.discriminator.parameters()), 'weights')

        train_step, eval_step = self._steps()
        D_loss_ep, G_loss_ep = [], []
        for epoch in range(self.start, epochs + 1):
            self.gen_opt.lr, self.disc_opt.lr = gen_sched.lr, dsc_sched.lr
            self._say(f"Epoch {epoch} -- lr: {gen_sched.lr:5.3e}, "
                      f"{dsc_sched.lr:5.3e}")
            self._say("---------------------------------------------------"
                      "----")
            with maybe_trace(self.profile_dir,
                             enabled=epoch == self.start and self.is_main):
                loss_mean, n_images, elapsed = self._run_epoch(
                    train_data, train_step, 'Training: ', epoch=epoch)
            # a resume can find every batch of its epoch trained already:
            # then there are no fresh means
            D_loss_ep.append(loss_mean.get('disc', float('nan')))
            G_loss_ep.append(loss_mean.get('gen', float('nan')))
            if elapsed > 0:
                self._say(f"  {n_images} images in {elapsed:.3f}s "
                          f"({n_images / elapsed:.1f} img/s)")
            if neptune is not None and loss_mean:
                neptune['train/gen_loss'].append(loss_mean['gen'])
                neptune['train/disc_loss'].append(loss_mean['disc'])
            loss_mean, _, _ = self._run_epoch(val_data, eval_step,
                                              'Validation: ')
            if neptune is not None and loss_mean:
                neptune['eval/gen_loss'].append(loss_mean['gen'])
                neptune['eval/disc_loss'].append(loss_mean['disc'])
            # plateau steps on the validation means, exponential on the
            # epoch count
            gen_sched.epoch_end(epoch, loss_mean.get('gen'))
            dsc_sched.epoch_end(epoch, loss_mean.get('disc'))
            if epoch % save_freq == 0:
                self.save(epoch)
            if self.save_every_steps:
                # the epoch is complete: the rolling state says "next
                # epoch, nothing done", so a kill between epochs resumes
                # cleanly; the next epoch consumes the next loader
                # iteration
                le = getattr(train_data, 'epoch', None)
                self._save_step_state(
                    epoch + 1, 0, loader_epoch=None if le is None else le + 1)
        if self.checkpoint_format == 'orbax':
            if self.is_main:
                orbax_ckpt.wait()   # commit the last async save
            self._written()
        self.start = epochs + 1
        return G_loss_ep, D_loss_ep

    def _say(self, line):
        """Print on rank 0 only (every rank without a mesh)."""
        if self.is_main:
            print(line)

    def _written(self):
        """After rank 0's write: every rank waits until it is on disk."""
        if self.mesh is not None:
            self.mesh.barrier()

    def _resume_loader(self, train_data):
        """Mid-epoch resume: replay the interrupted run's loader order
        (``fast_forward`` to the loader iteration the epoch consumed, as
        the metadata records it, else the calendar epoch) and leave out
        the trained batches (``skip_next``, before they are decoded; a
        loader without it has them dropped in ``_run_epoch``)."""
        if not (self._resume_skip_batches or self._resume_loader_epoch):
            return
        if self._resume_skip_batches:
            self._say(f"Resuming mid-epoch: skipping the "
                      f"{self._resume_skip_batches} already-trained "
                      f"batches of epoch {self.start}")
        if hasattr(train_data, 'fast_forward'):
            train_data.fast_forward(
                (self._resume_loader_epoch or self.start) - 1)
        if self._resume_skip_batches and hasattr(train_data, 'skip_next'):
            train_data.skip_next(self._resume_skip_batches)
            self._resume_skip_delegated = True
        self._resume_loader_epoch = None

    def _run_epoch(self, data, step, desc, epoch=None):
        '''One pass over ``data``; a train pass when ``epoch`` is given.
        Each step's losses are stacked into one device tensor and read one
        step later, while the next step is queued, so the host never waits
        on the step it just queued (a rolling save waits for it). Under a
        mesh the image count is the global batches'.'''
        train = epoch is not None
        if hasattr(data, 'shuffle'):
            data.shuffle()
        # a mid-epoch resume: batches_done counts the trained batches
        # too, which the loader left out (skip_next) or this loop drops
        batches_done = self._resume_skip_batches if train else 0
        skip = 0 if self._resume_skip_delegated else batches_done
        if train:
            self._resume_skip_batches = 0
            self._resume_skip_delegated = False
        pbar = tqdm.tqdm(data, desc=desc, dynamic_ncols=True,
                         disable=not self.is_main)
        # the data ranks' rows make up the global batch
        ranks = 1 if self.mesh is None else self.mesh.data.size
        sums = defaultdict(float)
        count = n_images = 0
        pending = None   # (keys, stacked losses) of the previous step

        def accumulate():
            nonlocal count
            keys, values = pending
            for key, value in zip(keys, values.tolist()):
                sums[key] += value
            count += 1
            pbar.set_postfix_str(" ".join(
                f"{k}: {v / count:.2e}" for k, v in sums.items()))

        t0 = time.perf_counter()
        for input_img, target_mask in pbar:
            if skip > 0:
                skip -= 1
                continue
            n_images += int(input_img.shape[0]) * ranks
            losses = step(*self._place_batch(input_img, target_mask))
            if pending is not None:
                accumulate()
            keys = list(LOSS_KEYS) + [k for k in losses if k not in
                                      LOSS_KEYS]
            pending = (keys, torch.stack([losses[k].float() for k in keys]))
            if train:
                self.step += 1
                batches_done += 1
                if self.save_every_steps and \
                        batches_done % self.save_every_steps == 0:
                    self._save_step_state(
                        epoch, batches_done,
                        loader_epoch=getattr(data, 'epoch', None))
        if pending is not None:
            accumulate()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        return ({k: v / max(count, 1) for k, v in sums.items()}, n_images,
                elapsed)

    # checkpoints: generator_ep_###.npz / discriminator_ep_###.npz with
    # torch state_dict keys, as the JAX Trainer writes them
    def save(self, epoch):
        gen_savefile = f'{self.savefolder}generator_ep_{epoch:03d}.npz'
        disc_savefile = f'{self.savefolder}discriminator_ep_{epoch:03d}.npz'
        if self.is_main:
            print(f"Saving to {gen_savefile} and {disc_savefile}")
            ckpt.save_state_dict(gen_savefile, self.generator.state_dict())
            ckpt.save_state_dict(disc_savefile,
                                 self.discriminator.state_dict())
            if self.save_optimizer_state and \
                    self.checkpoint_format == 'orbax':
                # goes on while the training does; the next save, the
                # end of train() and a restore wait for it
                orbax_ckpt.save_async(
                    orbax_ckpt.orbax_path(self.savefolder, epoch),
                    self.training_state())
            elif self.save_optimizer_state:
                self._write_training_state(
                    f'{self.savefolder}training_state_ep_{epoch:03d}.pt')
        self._written()

    def training_state(self):
        """Everything a continuation needs that the epoch files lack: both
        models' weights, both optimizers' states, the dropout generator's
        state, the step count and, inside ``train()``, the LR schedules'
        state (as the next epoch starts from it)."""
        scheds = self._scheds
        return {'generator': self.generator.state_dict(),
                'discriminator': self.discriminator.state_dict(),
                'gen_opt': self.gen_opt.state_dict(),
                'disc_opt': self.disc_opt.state_dict(),
                'dropout_rng': self.generator.dropout_generator.get_state(),
                'step': self.step,
                'schedules': None if scheds is None else [
                    [type(s).__name__, vars(s)] for s in scheds]}

    def _write_training_state(self, path):
        """torch.save into a file of its own, then an atomic rename: a
        kill mid-write leaves the old file whole."""
        tmp = f'{path}.tmp'
        torch.save(self.training_state(), tmp)
        os.replace(tmp, path)

    def _restore_training_state(self, path):
        if path.endswith('.dcp'):
            # loaded in place into the live tensors; the copies below
            # then copy each onto itself
            state = orbax_ckpt.restore(path, self.training_state())
        else:
            # on the CPU first: a generator's state is a CPU tensor, and
            # the copies below move the rest to the models' device
            state = torch.load(path, map_location='cpu', weights_only=True)
        self.generator.load_state_dict(state['generator'])
        self.discriminator.load_state_dict(state['discriminator'])
        self.gen_opt.load_state_dict(state['gen_opt'])
        self.disc_opt.load_state_dict(state['disc_opt'])
        self.generator.dropout_generator.set_state(state['dropout_rng'])
        self._refresh_shadows()
        self.step = int(state['step'])
        # the schedules continue where they were: the reference's LR
        # fast-forward on resume (a fractional power of the decay) gives
        # another LR than the uninterrupted run's
        saved = state.get('schedules')
        if saved and [name for name, _ in saved] == [
                type(s).__name__ for s in self._scheds]:
            for sched, (_, values) in zip(self._scheds, saved):
                vars(sched).update(values)
        elif saved:
            self._say(f"note: the LR schedules of {os.path.basename(path)} "
                      f"are {[name for name, _ in saved]}; these start "
                      f"from the fast-forwarded LR")
        self._say(f"Restored optimizer state from {os.path.basename(path)}")

    def _save_step_state(self, epoch, batches_done, loader_epoch=None):
        """The rolling mid-epoch checkpoint: the training state into the
        slot the metadata does not name, then the metadata naming it
        (``epoch``, ``batches_done``, and ``loader_epoch``, the loader
        iteration the epoch consumes, so a resume of a resumed run replays
        the right order). A kill at any point leaves the metadata naming
        a whole state file."""
        self._step_slot = 'b' if self._step_slot == 'a' else 'a'
        dcp = self.checkpoint_format == 'orbax'
        name = f'training_state_step_{self._step_slot}.' + \
            ('dcp' if dcp else 'pt')
        if self.is_main:
            path = os.path.join(self.savefolder, name)
            if dcp:
                orbax_ckpt.save_async(path, self.training_state())
                orbax_ckpt.wait()   # the metadata never precedes the state
            else:
                self._write_training_state(path)
            meta = os.path.join(self.savefolder, STEP_META)
            with open(f'{meta}.tmp', 'w') as f:
                json.dump({'epoch': int(epoch),
                           'batches_done': int(batches_done),
                           'loader_epoch': loader_epoch, 'state': name}, f)
            os.replace(f'{meta}.tmp', meta)
        self._written()

    def _check_step_state(self):
        """Take up the rolling checkpoint when it is further along than
        the epoch files (progress into an epoch not saved yet)."""
        meta_path = os.path.join(self.savefolder, STEP_META)
        if not os.path.exists(meta_path):
            return
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            state_path = os.path.join(self.savefolder, meta['state'])
            if meta['epoch'] < self.start or not os.path.exists(state_path):
                return
            self._pending_training_state = state_path
            self.start = int(meta['epoch'])
            self._resume_skip_batches = int(meta['batches_done'])
            self._resume_loader_epoch = meta.get('loader_epoch')
            # the next save writes the other slot, never the one the
            # metadata names
            slot = re.search(r'_([ab])\.(pt|dcp)$', meta['state'])
            if slot:
                self._step_slot = slot.group(1)
            self._say(f"Found mid-epoch checkpoint: epoch {self.start}, "
                      f"{self._resume_skip_batches} batches done")
        except Exception as e:
            print(f"Ignoring unreadable step checkpoint: {e}")

    def load(self, generator_save, discriminator_save):
        self._say(f'{generator_save} {discriminator_save}')
        counts = []
        for module, path in ((self.generator, generator_save),
                             (self.discriminator, discriminator_save)):
            state = ckpt.load_state_dict(path)
            counts.append((load_transfer_data(module, state, verbose=False),
                           len(module.state_dict())))
        (g_count, g_total), (d_count, d_total) = counts
        self._refresh_shadows()
        if g_count < g_total or d_count < d_total:
            raise ValueError(
                f"Checkpoint mismatch: loaded {g_count}/{g_total} "
                f"generator and {d_count}/{d_total} discriminator weights")
        self._say(f"Loaded checkpoints from "
                  f"{os.path.basename(generator_save)} and "
                  f"{os.path.basename(discriminator_save)}")

    def load_last_checkpoint(self):
        '''Resume from the latest epoch files, with their exact-resume
        state when there is one (``training_state_ep_###.dcp/``, else
        ``.pt``); without any (or with a broken pair) training starts
        afresh, as in the JAX package. A rolling checkpoint further along
        supersedes them.'''
        orbax_ckpt.wait()   # a save of this process still in flight
        try:
            last, gen_path, disc_path = ckpt.find_last_checkpoint(
                self.savefolder)
            self.load(gen_path, disc_path)
            self.start = last + 1
            for state_path in (
                    orbax_ckpt.orbax_path(self.savefolder, last),
                    f'{self.savefolder}training_state_ep_{last:03d}.pt'):
                if os.path.exists(state_path):
                    # restored in train(), once the optimizers exist
                    self._pending_training_state = state_path
                    break
            for jax_file in (f'training_state_ep_{last:03d}.msgpack',
                             f'training_state_ep_{last:03d}.orbax',
                             'step_state.json'):
                if os.path.exists(os.path.join(self.savefolder, jax_file)):
                    self._say(f"note: {jax_file} is the JAX package's "
                          f"exact-resume state, which this package does "
                          f"not read")
        except Exception as e:   # e.g. a file cut short by a killed save
            print(e)
            print("Checkpoints not loaded")
        self._check_step_state()

    def load_transfer_checkpoints(self, gen_checkpoint, disc_checkpoint):
        '''Shape-matched partial load for transfer learning.'''
        load_transfer_data(self.generator,
                           ckpt.load_state_dict(gen_checkpoint))
        load_transfer_data(self.discriminator,
                           ckpt.load_state_dict(disc_checkpoint))
        self._refresh_shadows()
