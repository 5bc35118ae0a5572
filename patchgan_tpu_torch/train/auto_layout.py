"""The train state in channels_last, and the generator's shadow.

Port of ``patchgan_tpu/train/auto_layout.py``. The JAX package computes
every conv in NHWC and lets XLA choose the layouts of the train state at
the jitted step's boundary (``AutoLayoutStep``); the port is NCHW, and
cuDNN transposes each conv's operands to NHWC and back (3.4 ms of the
captured config-2 step on an H100, ``PERF.md``). With the layout on, the
port holds the state and every activation of the step in
``torch.channels_last``: cuDNN runs its convs in their own layout, and the
port's kernels take their NHWC forms (``ops/kernels``, ``csrc/
norm_nhwc.cuh``). What each JAX piece became:

- ``AutoLayoutStep``'s AOT compile with ``Format(Layout.AUTO)`` on the
  state, and the one relayouting ``device_put``: ``to_layout``, once,
  on the models' 4-D parameters and the optimizers' moments and
  accumulators; the optimizers update them in place, so they stay in it,
  as donation keeps the JAX state in its formats;
- "batches keep their incoming layouts": the step converts x and y once
  at its entry (``train/steps.py``, ``layout=``), inside the captured
  graph on the card;
- the bf16 generator shadow (``shadow_fn`` / ``shadow_dtype``, JAX
  ``steps.py:301-310``): ``make_shadows`` casts the generator's
  parameters once; the step's forward consumes them, takes its gradients
  with respect to them, casts those to the masters' dtype where the
  autograd of the blocks' ``w.to(x.dtype)`` would, and after Adam's
  update refreshes them with ``refresh_shadows`` in the same (captured)
  step. Any write to the masters outside the step re-derives them (the
  Trainer's load, restore and transfer load), as the JAX wrapper
  re-derives its shadow for a state it did not produce;
- the fallbacks warned once per process (``_downgrade``): ``warn_once``,
  where the Trainer keeps NCHW on the forms this port has no
  channels_last path for yet (the space-to-depth form, any mesh).

Three JAX pieces have no torch meaning: the AOT formats themselves (a
torch tensor carries its layout; nothing is compiled against one), the
persistent-cache bypass (``_cache_bypass``: no compilation cache holds a
layout here), and the format fix-point check with its snapshot and probes
(an in-place update cannot change a tensor's layout, so a step's output
state is in its input's layout by construction).

``auto_layout_enabled`` and ``shadow_params_enabled`` read the JAX
package's own switches, ``PATCHGAN_AUTO_LAYOUT`` and
``PATCHGAN_SHADOW_PARAMS``, as ``train/graph.py`` reads its flag.
"""

import os
import warnings

import torch

LAYOUT = 'channels_last'
# PATCHGAN_AUTO_LAYOUT when unset: the Trainer's layout (PERF.md says why)
DEFAULT = 'on'
# PATCHGAN_SHADOW_PARAMS when unset (the JAX Trainer's default)
SHADOW_DEFAULT = 'on'

_warned = set()


def _flag(name, default):
    return os.environ.get(name, default).lower() not in ('off', '0', 'false')


def auto_layout_enabled():
    """``PATCHGAN_AUTO_LAYOUT``: off, 0 or false keep the train state NCHW,
    any other value selects channels_last."""
    return _flag('PATCHGAN_AUTO_LAYOUT', DEFAULT)


def shadow_params_enabled():
    """``PATCHGAN_SHADOW_PARAMS``: off, 0 or false turn the generator's
    shadow off, any other value on (where the layout is on and the
    generator computes in another dtype than its fp32 masters)."""
    return _flag('PATCHGAN_SHADOW_PARAMS', SHADOW_DEFAULT)


def warn_once(key, msg):
    """Warn ``msg`` once per process for ``key``."""
    if key not in _warned:
        _warned.add(key)
        warnings.warn(msg, stacklevel=3)


def check_layout(layout):
    """``layout`` must be None (NCHW) or ``LAYOUT``."""
    if layout not in (None, LAYOUT):
        raise ValueError(f"layout must be None or {LAYOUT!r}, not "
                         f"{layout!r}")


def in_layout(t, layout):
    """A 4-D tensor in ``layout`` (t itself where it is in it already);
    other ranks, and any tensor with ``layout`` None, as they are."""
    if layout is None or t.dim() != 4:
        return t
    return t.contiguous(memory_format=torch.channels_last)


def _optimizer_lists(opt):
    """The optimizer's per-parameter state lists (``train/steps.py``'s
    Adam and MultiSteps): the moments, and a MultiSteps' accumulator."""
    lists = []
    if hasattr(opt, 'acc'):
        lists.append(opt.acc)
        opt = opt.inner
    return lists + [opt.mu, opt.nu]


@torch.no_grad()
def to_layout(modules=(), optimizers=(), layout=LAYOUT):
    """Every 4-D parameter and buffer of ``modules``, and every 4-D tensor
    of the optimizers' state, into ``layout`` once, in place (a
    parameter's data is swapped, the Parameter object kept): before a
    step is built or captured, since a captured step holds the tensors it
    read."""
    check_layout(layout)
    for module in modules:
        for t in [*module.parameters(), *module.buffers()]:
            if t.dim() == 4:
                t.data = in_layout(t.data, layout)
    for opt in optimizers:
        for tensors in _optimizer_lists(opt):
            for i, t in enumerate(tensors):
                tensors[i] = in_layout(t, layout)


def make_shadows(generator, dtype):
    """{name: the generator's parameter cast to ``dtype``}, in each
    parameter's layout: the casts the blocks make at use
    (``w.to(x.dtype)``), hoisted out of the step (JAX ``make_shadows``).
    Generator only: each of its parameters has one site per loss, so
    consuming the cast is bit-exact; the discriminator, applied to the
    real and the fake pair, keeps its per-site casts."""
    return {name: p.detach().to(dtype, copy=True)
            for name, p in generator.named_parameters()}


@torch.no_grad()
def refresh_shadows(shadows, generator):
    """Copy the generator's masters into ``shadows`` in place (the cast
    ``make_shadows`` makes), so a captured step that reads them sees the
    new values."""
    named = dict(generator.named_parameters())
    torch._foreach_copy_(list(shadows.values()),
                         [named[n] for n in shadows])
