"""The fused G+D train step, the eval step, Adam and the loss dispatch.

Port of ``patchgan_tpu/train/steps.py``. The order of one train step is
the reference's (``:376-419``):

1. generator forward (dropout on), segmentation loss + the BCE of the
   pre-update discriminator on (x, gen_img), gradients for the generator
   only;
2. the generator's Adam step;
3. the discriminator's loss on (x, y) as real and (x, detached
   pre-update gen_img) as fake, its gradients and Adam step.

``s2d`` steps (``:216-237, 376-466``) take x and y to their
space-to-depth form at entry, run both models in that form and give the
segmentation loss and the IoU ``fold_blocks`` of the s2d tensors
(``ops/s2d.py``).

A generator optimizer built over ``trainable_params(generator,
freeze_patterns)`` freezes the parameters whose JAX path starts with a
pattern (JAX ``:41-71``): the step holds every generator parameter its
optimizer lacks constant. ``make_optimizer(every_k=k)`` applies the
update every k-th step on the running mean of the gradients
(``optax.MultiSteps``, ``:114-115``).

Steps return their losses as 0-d tensors on the device under the
reference's keys ``gen, gen_loss, gdisc, discr, discf, disc``; nothing
in a step waits for the device.
"""

import contextlib
import os

import numpy as np
import torch

from ..models.disc import Discriminator
from ..ops.losses import bce_loss, fc_tversky, mae_loss, weighted_bce_loss
from ..ops.s2d import fold_blocks, space_to_depth
from ..utils.metrics import iou
from ..utils.transfer import unet_jax_path

LOSS_KEYS = ('gen', 'gen_loss', 'gdisc', 'discr', 'discf', 'disc')


def _f32(v):
    """A hyperparameter rounded to float32, as ``inject_hyperparams(...,
    hyperparam_dtype=float32)`` holds it (``:98-104``)."""
    return float(np.float32(v))


class Adam:
    """Adam over ``torch._foreach_*``, the update of ``optax.adam`` with
    fp32 hyperparameters and a mutable ``lr``:

        mu <- b1 mu + (1 - b1) g          nu <- b2 nu + (1 - b2) g^2
        p  <- p - lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    ``mu_dtype=torch.bfloat16`` stores the first moment in bf16 beside
    fp32 parameters, as optax's ``mu_dtype`` does: the moment update and
    the step run in fp32 from the stored value, and only the stored
    moment is rounded (``optax.scale_by_adam``). ``torch.optim.Adam``
    keeps its moments in the parameters' dtype."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 mu_dtype=None):
        self.params = [p for p in params]
        self.lr = lr
        self.b1, self.b2, self.eps = _f32(b1), _f32(b2), _f32(eps)
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        """Apply one update from ``grads`` (one per parameter, in the
        parameters' dtype)."""
        self.count += 1
        one = np.float32(1)
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        bc1 = float(one - b1 ** np.float32(self.count))
        bc2 = float(one - b2 ** np.float32(self.count))
        low = self.mu[0].dtype != self.params[0].dtype if self.mu else False
        mu = [m.float() for m in self.mu] if low else self.mu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=float(one - b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads,
                                value=float(one - b2))
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(self.params, upd, alpha=-_f32(self.lr))
        if low:
            torch._foreach_copy_(self.mu, mu)


class MultiSteps:
    """Gradient accumulation around an ``Adam``: ``optax.MultiSteps`` with
    ``use_grad_mean=True``. Each call folds the gradients into one fp32
    accumulator per parameter, acc <- acc + (g - acc) / (mini_step + 1);
    the k-th call runs the inner ``step`` on it, then zeroes it. The
    k-th call is counted on the host, so nothing waits for the card."""

    def __init__(self, inner, every_k):
        self.inner, self.every_k = inner, every_k
        self.acc = [torch.zeros_like(p, dtype=torch.float32)
                    for p in inner.params]
        self.mini_step = 0

    @property
    def params(self):
        return self.inner.params

    @property
    def lr(self):
        return self.inner.lr

    @lr.setter
    def lr(self, value):
        self.inner.lr = value

    @torch.no_grad()
    def step(self, grads):
        delta = torch._foreach_sub([g.float() for g in grads], self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        del delta   # freed before the inner step's own temporaries
        self.mini_step += 1
        if self.mini_step == self.every_k:
            self.inner.step(self.acc)
            torch._foreach_zero_(self.acc)
            self.mini_step = 0


def make_optimizer(params, learning_rate=1e-3, b1=0.9, b2=0.999,
                   mu_dtype=None, every_k=1):
    """Adam(b1, b2) with eps 1e-8 over ``params`` (``:74-116``); its
    ``lr`` attribute is the learning rate, changed between epochs. With
    ``every_k`` > 1, the ``MultiSteps`` around it."""
    opt = Adam(params, learning_rate, b1, b2, mu_dtype=mu_dtype)
    return MultiSteps(opt, every_k) if every_k and every_k > 1 else opt


def is_frozen(name, freeze_patterns):
    """Whether the generator parameter ``name`` (a state_dict key) is
    frozen: its JAX path starts with one of ``freeze_patterns``, as the
    JAX step's ``_is_frozen`` tests it. A pattern that matches no path
    freezes nothing."""
    path = unet_jax_path(name)
    return any(path.startswith(pat) for pat in freeze_patterns)


def trainable_params(generator, freeze_patterns=()):
    """The generator's parameters that ``freeze_patterns`` leave
    trainable, in ``parameters()`` order: what its optimizer holds."""
    return [p for n, p in generator.named_parameters()
            if not is_frozen(n, freeze_patterns)]


def make_seg_loss(loss_type, seg_alpha, tversky_beta=0.75,
                  tversky_gamma=0.75, bce_weighting='complement'):
    """Segmentation loss dispatch (``:160-213``), NCHW: 'tversky' (focal
    Tversky), 'weighted_bce' with 'complement' / 'inverse' / 'none'
    class weights, 'MAE'; each scaled by ``seg_alpha``."""
    if loss_type == 'tversky':
        def seg(gen_img, y):
            return fc_tversky(y, gen_img, beta=tversky_beta,
                              gamma=tversky_gamma) * seg_alpha
    elif loss_type == 'weighted_bce':
        if bce_weighting not in ('complement', 'inverse', 'none'):
            raise ValueError(
                f"bce_weighting {bce_weighting!r} not in "
                "('complement', 'inverse', 'none')")

        def seg(gen_img, y):
            c = gen_img.shape[1]
            yf = y.float()
            if c > 1 and bce_weighting == 'inverse':
                # batch-level shares, floored so absent classes cannot
                # absorb all the gradient signal
                share = yf.sum(dim=(0, 2, 3), keepdim=True) / yf.sum()
                inv = 1.0 / share.clamp(min=1.0 / (100.0 * c))
                weight = (c * inv / inv.sum()).expand(y.shape[0], c, 1, 1)
            elif c > 1 and bce_weighting == 'complement':
                share = yf.sum(dim=(2, 3), keepdim=True) / yf.sum()
                weight = 1.0 - share
            else:
                weight = torch.ones_like(yf)
            return weighted_bce_loss(gen_img, y, weight) * seg_alpha
    elif loss_type == 'MAE':
        def seg(gen_img, y):
            return mae_loss(gen_img, y) * seg_alpha
    else:
        raise ValueError(f"Unknown loss_type: {loss_type!r}")
    return seg


@contextlib.contextmanager
def constant_params(params):
    """``params`` as constants for the block, every ``requires_grad`` flag
    as it was after it: the generator's loss reads the discriminator but
    takes no gradient for it, as JAX's ``value_and_grad`` over the
    generator's parameters does, and frozen generator parameters take
    none, as JAX's ``freeze_stop_gradients``. A custom
    ``autograd.Function`` fixes which gradients its backward computes at
    the forward (``ctx.needs_input_grad``), so without this the fake
    conv0 would launch K4-wgrad, and a frozen encoder K2's recompute and
    K1-bwd, for gradients that are thrown away."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def gan_losses(generator, discriminator, seg_loss, x, y, s2d=False):
    """The generator's loss: segmentation + BCE(D(x, gen_img), 1), x and
    y in the form ``s2d`` says. Returns (loss, gen_img, gdisc)."""
    gen_img = generator(x, s2d=s2d)
    disc_fake = discriminator(x, gen_img, s2d=s2d)
    seg = seg_loss(fold_blocks(gen_img), fold_blocks(y)) if s2d else \
        seg_loss(gen_img, y)
    gdisc = bce_loss(disc_fake, torch.ones_like(disc_fake))
    return seg + gdisc, gen_img, gdisc


def disc_real_fake(discriminator, x, y, gen_img, merged=True, paired=False,
                   s2d=False):
    """The discriminator's outputs on (x, y) and (x, gen_img)
    (``:239-272``): ``paired`` runs the tuple-of-masks form, conv0's image
    part shared; ``merged`` one forward of the two pairs stacked along
    the batch; otherwise two forwards."""
    y = y.to(gen_img.dtype)
    if paired:
        return discriminator(x, (y, gen_img), s2d=s2d)
    if merged:
        both = discriminator(torch.cat([x, x]), torch.cat([y, gen_img]),
                             s2d=s2d)
        return both.chunk(2)
    return discriminator(x, y, s2d=s2d), discriminator(x, gen_img, s2d=s2d)


def resolve_paired_disc(discriminator):
    """Whether the train step uses the paired form (``:275-298``): for
    the port's Discriminator, which takes a tuple of masks, unless
    ``PATCHGAN_PAIRED_DISC`` is off, 0 or false; otherwise two separate
    forwards."""
    return (isinstance(discriminator, Discriminator)
            and os.environ.get('PATCHGAN_PAIRED_DISC', 'on').lower()
            not in ('off', '0', 'false'))


def disc_loss(disc_real, disc_fake):
    """(mean of the two, real, fake) BCE losses of the discriminator."""
    loss_real = bce_loss(disc_real, torch.ones_like(disc_real))
    loss_fake = bce_loss(disc_fake, torch.zeros_like(disc_fake))
    return (loss_fake + loss_real) / 2.0, loss_real, loss_fake


def make_train_step(generator, discriminator, gen_opt, disc_opt,
                    loss_type='tversky', seg_alpha=200.0, tversky_beta=0.75,
                    tversky_gamma=0.75, bce_weighting='complement',
                    s2d=False):
    """``step(x, y) -> losses``: one G+D update in place on the models
    and their optimizers (``make_optimizer``). x and y are NCHW; ``s2d``
    runs the step in the space-to-depth form. The discriminator step
    takes the paired form ``resolve_paired_disc`` picks, else two
    separate forwards. The generator's gradient is taken over the
    parameters its optimizer holds (``trainable_params``) only, the
    others constant through its forward and backward, so autograd
    records no node that only a frozen gradient needs."""
    seg_loss = make_seg_loss(loss_type, seg_alpha, tversky_beta,
                             tversky_gamma, bce_weighting)
    paired = resolve_paired_disc(discriminator)
    g_params = list(gen_opt.params)
    trainable = {id(p) for p in g_params}
    d_params = list(discriminator.parameters())
    constants = d_params + [p for p in generator.parameters()
                            if id(p) not in trainable]

    def train_step(x, y):
        generator.train()
        if s2d:
            x, y = space_to_depth(x), space_to_depth(y)
        with constant_params(constants):
            g_loss, gen_img, gdisc = gan_losses(generator, discriminator,
                                                seg_loss, x, y, s2d)
            g_grads = torch.autograd.grad(g_loss, g_params)
        gen_opt.step(g_grads)
        gen_img = gen_img.detach()
        d_loss, loss_real, loss_fake = disc_loss(*disc_real_fake(
            discriminator, x, y, gen_img, merged=False, paired=paired,
            s2d=s2d))
        disc_opt.step(torch.autograd.grad(d_loss, d_params))
        g_loss, gdisc = g_loss.detach(), gdisc.detach()
        return dict(zip(LOSS_KEYS, (g_loss, g_loss, gdisc,
                                    loss_real.detach(), loss_fake.detach(),
                                    d_loss.detach())))

    return train_step


def make_eval_step(generator, discriminator, loss_type='tversky',
                   seg_alpha=200.0, tversky_beta=0.75, tversky_gamma=0.75,
                   compute_iou=False, bce_weighting='complement', s2d=False):
    """``step(x, y) -> losses``: the same losses with dropout off and no
    update (``:431-466``), the discriminator in the merged form, plus
    'iou' when ``compute_iou``; ``s2d`` as in ``make_train_step``."""
    seg_loss = make_seg_loss(loss_type, seg_alpha, tversky_beta,
                             tversky_gamma, bce_weighting)

    @torch.no_grad()
    def eval_step(x, y):
        generator.eval()
        if s2d:
            x, y = space_to_depth(x), space_to_depth(y)
        g_loss, gen_img, gdisc = gan_losses(generator, discriminator,
                                            seg_loss, x, y, s2d)
        d_loss, loss_real, loss_fake = disc_loss(*disc_real_fake(
            discriminator, x, y, gen_img, s2d=s2d))
        losses = dict(zip(LOSS_KEYS, (g_loss, g_loss, gdisc, loss_real,
                                      loss_fake, d_loss)))
        if compute_iou:
            losses['iou'] = iou(fold_blocks(y), fold_blocks(gen_img)) \
                if s2d else iou(y, gen_img)
        return losses

    return eval_step
