"""Training runtime: the epoch loop, LR schedules, checkpoints and resume.

Port of the part of ``patchgan_tpu/train/trainer.py`` that epochs,
checkpoints, resume and fine-tuning need: the class attributes
(``:71-97``), ``batch()``, ``train()`` with the LR fast-forward on
resume, exponential decay and plateau schedules, ``_run_epoch`` with the
losses fetched one step late (``:485-525``), ``save`` / ``load`` /
``load_last_checkpoint`` (npz epoch files with torch state_dict keys,
which the JAX Trainer reads and writes too), ``load_transfer_checkpoints``,
and ``freeze_generator`` / ``accumulate_steps`` (``:91-97, 154-160``),
which, as in the JAX Trainer, take effect when ``train()`` rebuilds the
optimizers.

``generator`` and ``discriminator`` are the port's ``nn.Module``s with
fp32 parameters; they compute in their own ``dtype``. Batches are NCHW
tensors (or numpy arrays), moved to the models' device. Each batch runs
the space-to-depth boundary form (``ops/s2d.py``) when ``PATCHGAN_S2D``
selects it and its H and W are even (``:232-251``); the checkpoints are
the same in both forms. Options of the JAX Trainer that are not ported
raise ``NotImplementedError`` at ``train()`` rather than being ignored.
"""

import os
import time
from collections import defaultdict

import numpy as np
import torch
import tqdm

from ..ops.s2d import s2d_enabled
from ..utils import checkpoint as ckpt
from ..utils.transfer import load_transfer_data
from .schedulers import (ConstantLR, ExponentialDecay, ReduceLROnPlateau,
                         resume_fast_forward)
from .steps import (LOSS_KEYS, make_eval_step, make_optimizer,
                    make_train_step, trainable_params)

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1 item 5)"


class Trainer:
    '''Owns the G+D step, the epoch loop, and checkpoint save/resume.'''

    seg_alpha = 200
    loss_type = 'tversky'
    tversky_beta = 0.75
    tversky_gamma = 0.75
    bce_weighting = 'complement'

    neptune_config = None
    compute_iou = False
    profile_dir = None
    save_optimizer_state = False
    checkpoint_format = 'msgpack'
    save_every_steps = None
    adam_mu_dtype = None   # torch.bfloat16 stores Adam's first moment
    freeze_generator = ()  # JAX path prefixes to freeze, e.g. ('enc',)
    accumulate_steps = 1   # apply the update every N batches on the
    #                        running mean of their gradients

    def __init__(self, generator, discriminator, savefolder, device=None,
                 seed=0):
        '''savefolder is created if missing. ``device`` defaults to the
        generator's; ``seed`` seeds the dropout generator on it.'''
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
        os.makedirs(savefolder, exist_ok=True)
        self.seed = seed
        self.start = 1
        self._make_optimizers(1e-3, 1e-3)

    def _make_optimizers(self, gen_lr, dsc_lr):
        """Both optimizers, accumulating in lockstep; the generator's over
        the parameters ``freeze_generator`` leaves trainable; the steps
        hold the others constant."""
        every_k = self.accumulate_steps or 1
        self.gen_opt = make_optimizer(
            trainable_params(self.generator, tuple(self.freeze_generator)),
            gen_lr, mu_dtype=self.adam_mu_dtype, every_k=every_k)
        self.disc_opt = make_optimizer(self.discriminator.parameters(),
                                       dsc_lr, mu_dtype=self.adam_mu_dtype,
                                       every_k=every_k)

    def _check_ported(self):
        unported = {
            'save_optimizer_state': self.save_optimizer_state,
            'checkpoint_format': self.checkpoint_format != 'msgpack',
            'save_every_steps': self.save_every_steps,
            'neptune_config': self.neptune_config is not None,
            'profile_dir': self.profile_dir,
        }
        for name, is_set in unported.items():
            if is_set:
                raise NotImplementedError(f"Trainer.{name} {_NOT_PORTED}")

    @staticmethod
    def _use_s2d(x):
        """The s2d form for an NCHW batch: ``PATCHGAN_S2D`` on and even H
        and W (the 2x2 block grid)."""
        return s2d_enabled() and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0

    def _steps(self):
        """(train step, eval step), each running a batch in the form
        ``_use_s2d`` picks for it."""
        loss_kwargs = dict(loss_type=self.loss_type,
                           seg_alpha=self.seg_alpha,
                           tversky_beta=self.tversky_beta,
                           tversky_gamma=self.tversky_gamma,
                           bce_weighting=self.bce_weighting)
        forms = {}

        def form(x):
            s2d = self._use_s2d(x)
            if s2d not in forms:
                forms[s2d] = (
                    make_train_step(self.generator, self.discriminator,
                                    self.gen_opt, self.disc_opt, s2d=s2d,
                                    **loss_kwargs),
                    make_eval_step(self.generator, self.discriminator,
                                   compute_iou=self.compute_iou, s2d=s2d,
                                   **loss_kwargs))
            return forms[s2d]

        return (lambda x, y: form(x)[0](x, y),
                lambda x, y: form(x)[1](x, y))

    def _place_batch(self, x, y):
        def place(a):
            if not torch.is_tensor(a):
                a = torch.from_numpy(np.asarray(a))
            return a.to(self.device, non_blocking=True)
        return place(x), place(y)

    def batch(self, x, y, train=False):
        '''One G+D step (train=True) or loss evaluation (train=False) on
        one NCHW batch; the reference's dict of Python floats.'''
        self._check_ported()
        train_step, eval_step = self._steps()
        x, y = self._place_batch(x, y)
        losses = (train_step if train else eval_step)(x, y)
        return {k: float(v) for k, v in losses.items()}

    def train(self, train_data, val_data, epochs, dsc_learning_rate=1.e-3,
              gen_learning_rate=1.e-3, save_freq=10, lr_decay=None,
              decay_freq=5, reduce_on_plateau=False):
        '''The epoch loop from ``self.start`` to ``epochs``; returns the
        per-epoch mean (G, D) training losses. A resumed run starts from
        the fast-forwarded LR; Adam starts afresh each call, as in the
        reference; an accumulator carries across the call's epochs.'''
        self._check_ported()
        if (lr_decay is not None) and not reduce_on_plateau:
            gen_lr = resume_fast_forward(gen_learning_rate, lr_decay,
                                         self.start, decay_freq)
            dsc_lr = resume_fast_forward(dsc_learning_rate, lr_decay,
                                         self.start, decay_freq)
        else:
            gen_lr, dsc_lr = gen_learning_rate, dsc_learning_rate
        self._make_optimizers(gen_lr, dsc_lr)

        if reduce_on_plateau:
            gen_sched = ReduceLROnPlateau(gen_lr)
            dsc_sched = ReduceLROnPlateau(dsc_lr)
        elif lr_decay is not None:
            gen_sched = ExponentialDecay(gen_lr, lr_decay, decay_freq)
            dsc_sched = ExponentialDecay(dsc_lr, lr_decay, decay_freq)
        else:
            gen_sched, dsc_sched = ConstantLR(gen_lr), ConstantLR(dsc_lr)

        train_step, eval_step = self._steps()
        D_loss_ep, G_loss_ep = [], []
        for epoch in range(self.start, epochs + 1):
            self.gen_opt.lr, self.disc_opt.lr = gen_sched.lr, dsc_sched.lr
            print(f"Epoch {epoch} -- lr: {gen_sched.lr:5.3e}, "
                  f"{dsc_sched.lr:5.3e}")
            print("-------------------------------------------------------")
            loss_mean, n_images, elapsed = self._run_epoch(
                train_data, train_step, 'Training: ')
            D_loss_ep.append(loss_mean.get('disc', float('nan')))
            G_loss_ep.append(loss_mean.get('gen', float('nan')))
            if elapsed > 0:
                print(f"  {n_images} images in {elapsed:.3f}s "
                      f"({n_images / elapsed:.1f} img/s)")
            loss_mean, _, _ = self._run_epoch(val_data, eval_step,
                                              'Validation: ')
            # plateau steps on the validation means, exponential on the
            # epoch count
            gen_sched.epoch_end(epoch, loss_mean.get('gen'))
            dsc_sched.epoch_end(epoch, loss_mean.get('disc'))
            if epoch % save_freq == 0:
                self.save(epoch)
        self.start = epochs + 1
        return G_loss_ep, D_loss_ep

    def _run_epoch(self, data, step, desc):
        '''One pass over ``data``. Each step's losses are stacked into one
        device tensor and read one step later, while the next step is
        queued, so the host never waits on the step it just queued.'''
        if hasattr(data, 'shuffle'):
            data.shuffle()
        pbar = tqdm.tqdm(data, desc=desc, dynamic_ncols=True)
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
            n_images += int(input_img.shape[0])
            losses = step(*self._place_batch(input_img, target_mask))
            if pending is not None:
                accumulate()
            keys = list(LOSS_KEYS) + [k for k in losses if k not in
                                      LOSS_KEYS]
            pending = (keys, torch.stack([losses[k].float() for k in keys]))
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
        print(f"Saving to {gen_savefile} and {disc_savefile}")
        ckpt.save_state_dict(gen_savefile, self.generator.state_dict())
        ckpt.save_state_dict(disc_savefile, self.discriminator.state_dict())

    def load(self, generator_save, discriminator_save):
        print(generator_save, discriminator_save)
        counts = []
        for module, path in ((self.generator, generator_save),
                             (self.discriminator, discriminator_save)):
            state = ckpt.load_state_dict(path)
            counts.append((load_transfer_data(module, state, verbose=False),
                           len(module.state_dict())))
        (g_count, g_total), (d_count, d_total) = counts
        if g_count < g_total or d_count < d_total:
            raise ValueError(
                f"Checkpoint mismatch: loaded {g_count}/{g_total} "
                f"generator and {d_count}/{d_total} discriminator weights")
        print(f"Loaded checkpoints from {os.path.basename(generator_save)} "
              f"and {os.path.basename(discriminator_save)}")

    def load_last_checkpoint(self):
        '''Resume from the latest epoch files; without any (or with a
        broken pair) training starts afresh, as in the JAX package.'''
        try:
            last, gen_path, disc_path = ckpt.find_last_checkpoint(
                self.savefolder)
            self.load(gen_path, disc_path)
            self.start = last + 1
        except Exception as e:   # e.g. a file cut short by a killed save
            print(e)
            print("Checkpoints not loaded")
            return
        for extra in (f'training_state_ep_{last:03d}.msgpack',
                      'step_state.json'):
            if os.path.exists(os.path.join(self.savefolder, extra)):
                print(f"note: {extra} holds exact-resume state, which "
                      f"{_NOT_PORTED}; resuming from the epoch weights "
                      f"with fresh Adam moments")

    def load_transfer_checkpoints(self, gen_checkpoint, disc_checkpoint):
        '''Shape-matched partial load for transfer learning.'''
        load_transfer_data(self.generator,
                           ckpt.load_state_dict(gen_checkpoint))
        load_transfer_data(self.discriminator,
                           ckpt.load_state_dict(disc_checkpoint))
