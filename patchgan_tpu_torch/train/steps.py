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

``make_train_step(..., graph=True)`` is the counterpart of the JAX
Trainer's jitted step: the same step captured as a CUDA graph
(``train/graph.py``).

``mesh`` (a ``parallel.mesh.DataMesh``) makes a step data-parallel, the
counterpart of the JAX step on a batch sharded over a mesh (JAX
``tests/test_distributed.py``): each rank steps on its rows of the
global batch, every batch mean and batch statistic of the losses is the
global batch's (``ops/losses.py``, ``utils/metrics.py``; the dropout
masks too, ``models/blocks.py``), and the generator's trainable
gradients and the discriminator's are summed over the ranks, one bucket
each, between ``autograd.grad`` and the optimizer's update (at every
micro-step under ``MultiSteps``, as the JAX step psums inside each
call). So every rank applies the update one process would apply on the
concatenated batch, and reports the global losses.

A ``parallel.HybridMesh`` adds a model axis (``parallel/sharding.py``,
the counterpart of the JAX step on ``hybrid_mesh``): the models take the
whole mesh and run each sharded conv on its output channels, gathering
them within the model group in the forward and summing their inputs'
gradients over it in the backward; the losses, their statistics and the
gradient buckets go over the mesh's data axis (``mesh.data``, a
``DataMesh``) only, since every rank of a model group computes them
alike.

A ``parallel.spatial.SpatialMesh`` splits the rows too (JAX
``parallel/spatial.py``): the step takes each rank's rows of the global
batch whole in H and keeps its band of them (``SpatialMesh.band``); the
models run on the bands, the losses are reduced over both axes
(``ops/losses.py``), the class weights' sums and the gradient buckets over
every rank of the grid, since the parameters are replicated on all of it.
A batch whose height does not split (``SpatialMesh.splits``) runs with H
whole, as a data-parallel step over the data axis. The s2d form is
refused, as JAX turns it off on spatial meshes.

``layout='channels_last'`` (``train/auto_layout.py``, the counterpart of
the JAX Trainer's AUTO layouts) runs the step with the batch converted to
``torch.channels_last`` once at its entry, inside the captured graph on
the card: with the models' parameters and the optimizers' state in it
(``auto_layout.to_layout``), every activation, the losses' inputs and the
backward stay channels_last, and the kernels take their NHWC forms. The
s2d form and the meshes have no channels_last path yet and refuse it.

``shadow_dtype`` (JAX ``:316-368``): the step's generator forward consumes
``auto_layout.make_shadows(generator, shadow_dtype)``, its parameters cast
once, through ``torch.func.functional_call``; the gradients are taken with
respect to the shadows and cast to the masters' dtype, which is where the
autograd of the blocks' ``w.to(x.dtype)`` casts them, so the step is the
plain step's bits. After the generator's update the step refreshes the
shadows from the masters (in the captured graph too). The returned step
carries them as ``step.shadows``; a write to the masters outside the step
calls ``auto_layout.refresh_shadows``. ``grad_dtype`` casts both gradient
lists before the optimizers (after a mesh's sums).

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
from .auto_layout import check_layout, in_layout, make_shadows, \
    refresh_shadows

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
    keeps its moments in the parameters' dtype.

    The update reads the step count t (``count_t``) and the learning rate
    (as ``neg_lr_t`` = -lr) from device tensors beside the moments, as
    ``inject_hyperparams`` keeps the learning rate in the optimizer state
    (``:98-104``): a captured step (``train/graph.py``) reads them at
    every replay, so an LR write or a restored state reaches it without a
    recapture. ``step`` is
    ``update`` (the device work, which advances the device count) then
    ``advance`` (the host's ``count``); a captured step runs ``update``
    in the graph and ``advance`` after each replay."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 mu_dtype=None):
        self.params = [p for p in params]
        self.b1, self.b2, self.eps = _f32(b1), _f32(b2), _f32(eps)
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        device = self.params[0].device if self.params else None
        self.count_t = torch.zeros((), dtype=torch.int32, device=device)
        # -lr, the factor of the update
        self.neg_lr_t = torch.zeros((), dtype=torch.float32, device=device)
        self._betas = torch.tensor([self.b1, self.b2], dtype=torch.float32,
                                   device=device)
        self.count = 0
        self.lr = lr

    @property
    def lr(self):
        return self._lr

    @lr.setter
    def lr(self, value):
        self._lr = value
        self.neg_lr_t.fill_(-_f32(value))

    @torch.no_grad()
    def step(self, grads):
        """Apply one update from ``grads`` (one per parameter, in the
        parameters' dtype)."""
        self.update(grads)
        self.advance()

    @torch.no_grad()
    def update(self, grads):
        """The device work of one step; reads no host state that a step
        changes."""
        self.count_t.add_(1)
        bc1, bc2 = 1 - torch.pow(self._betas, self.count_t)
        one = np.float32(1)
        low = self.mu[0].dtype != self.params[0].dtype if self.mu else False
        mu = [m.float() for m in self.mu] if low else self.mu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=float(one - np.float32(self.b1)))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads,
                                value=float(one - np.float32(self.b2)))
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, self.neg_lr_t)
        torch._foreach_add_(self.params, upd)
        if low:
            torch._foreach_copy_(self.mu, mu)

    def advance(self):
        """The host's part of one step."""
        self.count += 1

    def state_dict(self):
        """The moments (the optimizer's own tensors), the step count and
        the learning rate."""
        return {'mu': self.mu, 'nu': self.nu, 'count': self.count,
                'lr': float(self.lr)}

    @torch.no_grad()
    def load_state_dict(self, state):
        """Copy a ``state_dict`` into this optimizer's tensors, in place;
        they must match in number and shape."""
        if 'mu' not in state:
            raise ValueError("optimizer state saved with gradient "
                             "accumulation; set accumulate_steps as it was")
        _copy_tensors('mu', self.mu, state['mu'])
        _copy_tensors('nu', self.nu, state['nu'])
        self.count, self.lr = int(state['count']), state['lr']
        self.count_t.fill_(self.count)


def _copy_tensors(name, dst, src):
    if len(dst) != len(src) or any(d.shape != s.shape
                                   for d, s in zip(dst, src)):
        raise ValueError(f"optimizer state {name!r} holds {len(src)} "
                         f"tensors that do not match the optimizer's "
                         f"{len(dst)} parameters")
    for d, s in zip(dst, src):
        d.copy_(s)


class MultiSteps:
    """Gradient accumulation around an ``Adam``: ``optax.MultiSteps`` with
    ``use_grad_mean=True``. Each call folds the gradients into one fp32
    accumulator per parameter, acc <- acc + (g - acc) / (mini_step + 1);
    the k-th call runs the inner ``update`` on it, then zeroes it. The
    k-th call is counted on the host, so nothing waits for the card: a
    captured step keeps one program per ``mini_step`` (``train/graph.py``).
    ``step`` is ``update`` then ``advance``, as in ``Adam``."""

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
        self.update(grads)
        self.advance()

    @torch.no_grad()
    def update(self, grads):
        delta = torch._foreach_sub([g.float() for g in grads], self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        del delta   # freed before the inner step's own temporaries
        if self.mini_step + 1 == self.every_k:
            self.inner.update(self.acc)
            torch._foreach_zero_(self.acc)

    def advance(self):
        self.mini_step += 1
        if self.mini_step == self.every_k:
            self.inner.advance()
            self.mini_step = 0

    def state_dict(self):
        """The inner Adam's state, the running mean and the mini-step
        count of the open window."""
        return {'inner': self.inner.state_dict(), 'acc': self.acc,
                'mini_step': self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state):
        if 'acc' not in state:
            raise ValueError("optimizer state saved without gradient "
                             "accumulation; set accumulate_steps as it was")
        self.inner.load_state_dict(state['inner'])
        _copy_tensors('acc', self.acc, state['acc'])
        self.mini_step = int(state['mini_step'])


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
                  tversky_gamma=0.75, bce_weighting='complement', mesh=None):
    """Segmentation loss dispatch (``:160-213``), NCHW: 'tversky' (focal
    Tversky), 'weighted_bce' with 'complement' / 'inverse' / 'none'
    class weights, 'MAE'; each scaled by ``seg_alpha``. With a ``mesh``
    the class weights come from the global batch's sums."""
    if loss_type == 'tversky':
        def seg(gen_img, y):
            return fc_tversky(y, gen_img, beta=tversky_beta,
                              gamma=tversky_gamma, mesh=mesh) * seg_alpha
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
                sums = torch.cat([yf.sum(dim=(0, 2, 3)), yf.sum().view(1)])
                if mesh is not None:
                    sums = mesh.stat(sums)
                share = sums[:c].view(1, c, 1, 1) / sums[c]
                inv = 1.0 / share.clamp(min=1.0 / (100.0 * c))
                weight = (c * inv / inv.sum()).expand(y.shape[0], c, 1, 1)
            elif c > 1 and bce_weighting == 'complement':
                total = yf.sum()
                per_sample = yf.sum(dim=(2, 3), keepdim=True)
                if mesh is not None:
                    total = mesh.stat(total)
                if getattr(mesh, 'spatial', None) is not None:
                    per_sample = mesh.spatial.stat(per_sample)
                share = per_sample / total
                weight = 1.0 - share
            else:
                weight = torch.ones_like(yf)
            return weighted_bce_loss(gen_img, y, weight, mesh) * seg_alpha
    elif loss_type == 'MAE':
        def seg(gen_img, y):
            return mae_loss(gen_img, y, mesh) * seg_alpha
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


def _data(mesh):
    """What a step's losses reduce over, and its gradient buckets sum over:
    the data axis of ``mesh``, or a ``SpatialMesh`` itself (both axes)."""
    if mesh is None or getattr(mesh, 'spatial', None) is not None:
        return mesh
    return mesh.data


def _spatial_form(mesh, x, y):
    """(mesh, x, y) a spatial step runs a batch with: the rank's bands over
    ``mesh`` where the height splits, else the whole rows over its data
    axis."""
    if getattr(mesh, 'spatial', None) is None:
        return mesh, x, y
    if mesh.splits(x.shape[2]):
        return (mesh,) + tuple(mesh.band((x, y)))
    return mesh.data, x, y


def gan_losses(generator, discriminator, seg_loss, x, y, s2d=False,
               mesh=None):
    """The generator's loss: segmentation + BCE(D(x, gen_img), 1), x and
    y in the form ``s2d`` says; ``generator`` the module or a callable
    taking its arguments (the shadow step's). Returns (loss, gen_img,
    gdisc)."""
    gen_img = generator(x, s2d=s2d, mesh=mesh)
    disc_fake = discriminator(x, gen_img, s2d=s2d, mesh=mesh)
    seg = seg_loss(fold_blocks(gen_img), fold_blocks(y)) if s2d else \
        seg_loss(gen_img, y)
    gdisc = bce_loss(disc_fake, torch.ones_like(disc_fake), _data(mesh))
    return seg + gdisc, gen_img, gdisc


def disc_real_fake(discriminator, x, y, gen_img, merged=True, paired=False,
                   s2d=False, mesh=None):
    """The discriminator's outputs on (x, y) and (x, gen_img)
    (``:239-272``): ``paired`` runs the tuple-of-masks form, conv0's image
    part shared; ``merged`` one forward of the two pairs stacked along
    the batch; otherwise two forwards."""
    y = y.to(gen_img.dtype)
    if paired:
        return discriminator(x, (y, gen_img), s2d=s2d, mesh=mesh)
    if merged:
        both = discriminator(torch.cat([x, x]), torch.cat([y, gen_img]),
                             s2d=s2d, mesh=mesh)
        return both.chunk(2)
    return (discriminator(x, y, s2d=s2d, mesh=mesh),
            discriminator(x, gen_img, s2d=s2d, mesh=mesh))


def resolve_paired_disc(discriminator):
    """Whether the train step uses the paired form (``:275-298``): for
    the port's Discriminator, which takes a tuple of masks, unless
    ``PATCHGAN_PAIRED_DISC`` is off, 0 or false; otherwise two separate
    forwards."""
    return (isinstance(discriminator, Discriminator)
            and os.environ.get('PATCHGAN_PAIRED_DISC', 'on').lower()
            not in ('off', '0', 'false'))


def disc_loss(disc_real, disc_fake, mesh=None):
    """(mean of the two, real, fake) BCE losses of the discriminator."""
    loss_real = bce_loss(disc_real, torch.ones_like(disc_real), mesh)
    loss_fake = bce_loss(disc_fake, torch.zeros_like(disc_fake), mesh)
    return (loss_fake + loss_real) / 2.0, loss_real, loss_fake


def _seg_losses(mesh, *settings):
    """{mesh: its segmentation loss} for the meshes a step may run a batch
    over: ``mesh``, and a spatial mesh's data axis as well."""
    meshes = [mesh]
    if getattr(mesh, 'spatial', None) is not None:
        meshes.append(mesh.data)
    return {m: make_seg_loss(*settings, mesh=_data(m)) for m in meshes}


def _refuse_layout(layout, s2d, mesh):
    """The forms without a channels_last path raise (ROADMAP.md, queue
    1)."""
    check_layout(layout)
    if layout is None:
        return
    if s2d:
        raise ValueError(f"layout={layout!r} with s2d=True: the "
                         f"space-to-depth form has no channels_last path "
                         f"yet (ROADMAP.md, queue 1: the NHWC forms of K4 "
                         f"and K4-wgrad)")
    if mesh is not None:
        raise ValueError(f"layout={layout!r} with a mesh: the meshes have "
                         f"no channels_last path yet (ROADMAP.md, queue 1: "
                         f"channels_last on meshes)")


def _grads_in(grads, dtype):
    return grads if dtype is None else [g.to(dtype) for g in grads]


def make_train_step(generator, discriminator, gen_opt, disc_opt,
                    loss_type='tversky', seg_alpha=200.0, tversky_beta=0.75,
                    tversky_gamma=0.75, bce_weighting='complement',
                    s2d=False, graph=False, mesh=None, layout=None,
                    shadow_dtype=None, grad_dtype=None):
    """``step(x, y) -> losses``: one G+D update in place on the models
    and their optimizers (``make_optimizer``). x and y are NCHW; ``s2d``
    runs the step in the space-to-depth form. The discriminator step
    takes the paired form ``resolve_paired_disc`` picks, else two
    separate forwards. The generator's gradient is taken over the
    parameters its optimizer holds (``trainable_params``) only, the
    others constant through its forward and backward, so autograd
    records no node that only a frozen gradient needs. ``graph=True``
    returns the step as a ``CapturedStep`` (``train/graph.py``): the
    same arithmetic, replayed as one CUDA graph per batch shape on the
    card. ``mesh`` makes it data-parallel, or data x model parallel (the
    module's docstring); its collectives are captured too, which NCCL's
    can be and gloo's not. ``layout``, ``shadow_dtype`` and
    ``grad_dtype`` as the module's docstring says; the shadows are
    ``step.shadows`` (None without ``shadow_dtype``)."""
    _refuse_layout(layout, s2d, mesh)
    if graph and mesh is not None and not mesh.capturable:
        raise ValueError(f"a {mesh.backend} process group cannot be "
                         f"captured into a CUDA graph; build the step "
                         f"with graph=False")
    if s2d and getattr(mesh, 'spatial', None) is not None:
        raise ValueError("the s2d form regroups the rows a spatial mesh "
                         "splits; a spatial step runs the plain form")
    seg_losses = _seg_losses(mesh, loss_type, seg_alpha, tversky_beta,
                             tversky_gamma, bce_weighting)
    paired = resolve_paired_disc(discriminator)
    g_params = list(gen_opt.params)
    trainable = {id(p) for p in g_params}
    d_params = list(discriminator.parameters())
    constants = d_params + [p for p in generator.parameters()
                            if id(p) not in trainable]
    shadows, g_wrt, g_fwd = None, g_params, generator
    if shadow_dtype is not None:
        shadows = make_shadows(generator, shadow_dtype)
        named = dict(generator.named_parameters())
        of = {id(named[n]): t for n, t in shadows.items()}
        g_wrt = [of[id(p)] for p in g_params]
        for t in g_wrt:
            t.requires_grad_(True)

        def g_fwd(x, **kwargs):
            return torch.func.functional_call(generator, shadows, (x,),
                                              kwargs)

    def run(x, y):
        # the device work of one step: no host counter moves here
        generator.train()
        x, y = in_layout(x, layout), in_layout(y, layout)
        if s2d:
            x, y = space_to_depth(x), space_to_depth(y)
        mesh_, x, y = _spatial_form(mesh, x, y)
        data, seg_loss = _data(mesh_), seg_losses[mesh_]
        with constant_params(constants):
            g_loss, gen_img, gdisc = gan_losses(g_fwd, discriminator,
                                                seg_loss, x, y, s2d, mesh_)
            g_grads = torch.autograd.grad(g_loss, g_wrt)
        if shadows is not None:
            # the cast the autograd of the blocks' w.to(x.dtype) makes
            g_grads = [g.to(p.dtype) for g, p in zip(g_grads, g_params)]
        if data is not None:
            data.sum_(g_grads)
        gen_opt.update(_grads_in(g_grads, grad_dtype))
        if shadows is not None:
            refresh_shadows(shadows, generator)
        gen_img = gen_img.detach()
        d_loss, loss_real, loss_fake = disc_loss(*disc_real_fake(
            discriminator, x, y, gen_img, merged=False, paired=paired,
            s2d=s2d, mesh=mesh_), data)
        d_grads = torch.autograd.grad(d_loss, d_params)
        if data is not None:
            data.sum_(d_grads)
        disc_opt.update(_grads_in(d_grads, grad_dtype))
        g_loss, gdisc = g_loss.detach(), gdisc.detach()
        return dict(zip(LOSS_KEYS, (g_loss, g_loss, gdisc,
                                    loss_real.detach(), loss_fake.detach(),
                                    d_loss.detach())))

    def advance():
        gen_opt.advance()
        disc_opt.advance()

    if graph:
        from .graph import CapturedStep
        step = CapturedStep(
            run, advance,
            position=lambda: (getattr(gen_opt, 'mini_step', 0),
                              getattr(disc_opt, 'mini_step', 0)),
            generators=lambda: [generator.dropout_generator])
        step.shadows = shadows
        if mesh is not None:
            mesh.hold(step)
        return step

    def train_step(x, y):
        losses = run(x, y)
        advance()
        return losses

    train_step.shadows = shadows
    return train_step


def make_eval_step(generator, discriminator, loss_type='tversky',
                   seg_alpha=200.0, tversky_beta=0.75, tversky_gamma=0.75,
                   compute_iou=False, bce_weighting='complement', s2d=False,
                   mesh=None, layout=None):
    """``step(x, y) -> losses``: the same losses with dropout off and no
    update (``:431-466``), the discriminator in the merged form, plus
    'iou' when ``compute_iou``; ``s2d``, ``mesh`` and ``layout`` as in
    ``make_train_step``: with a mesh, the global batch's losses and
    IoU. It casts the generator's parameters at use: a shadow is the
    train step's state, which the JAX eval step does not take either."""
    _refuse_layout(layout, s2d, mesh)
    if s2d and getattr(mesh, 'spatial', None) is not None:
        raise ValueError("a spatial step runs the plain form")
    seg_losses = _seg_losses(mesh, loss_type, seg_alpha, tversky_beta,
                             tversky_gamma, bce_weighting)

    @torch.no_grad()
    def eval_step(x, y):
        generator.eval()
        x, y = in_layout(x, layout), in_layout(y, layout)
        if s2d:
            x, y = space_to_depth(x), space_to_depth(y)
        mesh_, x, y = _spatial_form(mesh, x, y)
        data, seg_loss = _data(mesh_), seg_losses[mesh_]
        g_loss, gen_img, gdisc = gan_losses(generator, discriminator,
                                            seg_loss, x, y, s2d, mesh_)
        d_loss, loss_real, loss_fake = disc_loss(*disc_real_fake(
            discriminator, x, y, gen_img, s2d=s2d, mesh=mesh_), data)
        losses = dict(zip(LOSS_KEYS, (g_loss, g_loss, gdisc, loss_real,
                                      loss_fake, d_loss)))
        if compute_iou:
            losses['iou'] = iou(fold_blocks(y), fold_blocks(gen_img),
                                mesh=data) if s2d else \
                iou(y, gen_img, mesh=data)
        return losses

    return eval_step
