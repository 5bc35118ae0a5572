"""The G+D step in channels_last (``train/auto_layout.py``) on the CPU.

At nf=4, 128 px, batch 2, dropout off: the port's channels_last step,
with and without the generator's shadow, and with ``grad_dtype`` bf16,
against the JAX package's ``make_train_step`` at test_torch_step.py's
tolerances; every block's output channels_last, and the gradients too;
the shadow step bit-equal to the plain one over 3 steps (fp32 and bf16,
both layouts, and accumulating), its refreshed shadows equal to the cast
masters (JAX tests/test_shadow_step.py); the refusals of the forms
without a channels_last path and the Trainer's warning once; the Trainer's
choice of layout and shadow; the kernel wrappers' plain versions keeping a
channels_last input's layout, and the NHWC forms' host-side geometry.
"""

import warnings

import numpy as np
import pytest
import torch

import torch_parity
from patchgan_tpu_torch.models import Discriminator, UNet
from patchgan_tpu_torch.ops.kernels import (conv_norm_act, convt_norm_act,
                                            instance_norm_act,
                                            instance_norm_act_backward,
                                            pack_convt_weight_nhwc_plain,
                                            pack_convt_weight_plain)
from patchgan_tpu_torch.ops.kernels.norm_act import (in_layout_of, is_nhwc,
                                                     nhwc_plan,
                                                     nhwc_segments)
from patchgan_tpu_torch.train import auto_layout
from patchgan_tpu_torch.train.auto_layout import (LAYOUT, make_shadows,
                                                  to_layout)
from patchgan_tpu_torch.train.steps import (make_eval_step, make_optimizer,
                                            make_train_step)

torch.set_num_threads(2)

CL = torch.channels_last
CASES = {
    'relu-sigmoid-1class': ('relu', 1, 'sigmoid'),
    'leakyrelu-softmax-3class': ('leakyrelu', 3, 'softmax'),
}


@pytest.mark.parametrize('shadow', [False, True], ids=['plain', 'shadow'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_channels_last_step_matches_jax(case, shadow):
    act, out_c, final_act = CASES[case]
    jl, pl, first = torch_parity.run(128, act, out_c, final_act, 2,
                                     layout=LAYOUT, shadow=shadow)
    torch_parity.assert_losses_close(jl, pl)
    jg, jd, tg, td = first
    torch_parity.assert_params_close(jg, tg)
    torch_parity.assert_params_close(jd, td)
    assert all(v.is_contiguous(memory_format=CL)
               for v in [*tg.values(), *td.values()] if v.dim() == 4)


@pytest.mark.parametrize('layout', [None, LAYOUT], ids=['nchw', 'cl'])
def test_grad_dtype_matches_jax(layout):
    """``grad_dtype=bfloat16`` casts both gradient lists before Adam, as
    the JAX step's ``grad_dtype`` does."""
    jl, pl, first = torch_parity.run(128, 'relu', 1, 'sigmoid', 2,
                                     layout=layout, grad_dtype='bfloat16')
    torch_parity.assert_losses_close(jl, pl)
    jg, jd, tg, td = first
    torch_parity.assert_params_close(jg, tg)
    torch_parity.assert_params_close(jd, td)


def _models(dtype=torch.float32, out_c=3, dropout=False):
    init = torch.Generator().manual_seed(3)
    gen = UNet(3, out_c, nf=4, activation='relu', final_act='softmax',
               dtype=dtype, generator=init, use_dropout=dropout)
    disc = Discriminator(3 + out_c, ndf=4, n_layers=3, dtype=dtype,
                         generator=init)
    gen.dropout_generator = torch.Generator().manual_seed(0)
    return gen, disc


def _batches(n_steps, out_c=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        x = torch.from_numpy(rng.random((2, 3, 128, 128), dtype=np.float32))
        labels = torch.from_numpy(rng.integers(0, out_c, (2, 128, 128)))
        y = torch.nn.functional.one_hot(labels, out_c).permute(0, 3, 1, 2)
        out.append((x, y.float().contiguous()))
    return out


def test_activations_and_gradients_stay_channels_last():
    """A forward hook on every block: each output channels_last; the
    gradients of a loss with respect to every 4-D parameter too."""
    gen, disc = _models(dropout=True)
    to_layout((gen, disc))
    seen = []
    hooks = [b.register_forward_hook(
        lambda m, a, out: seen.append(out.is_contiguous(memory_format=CL)))
        for b in [*gen.encoder, *gen.decoder]]
    gen.train()
    x, y = _batches(1)[0]
    out = gen(x.contiguous(memory_format=CL))
    d = disc(x.contiguous(memory_format=CL), (y.contiguous(
        memory_format=CL), out))
    for h in hooks:
        h.remove()
    assert seen == [True] * 14
    assert out.is_contiguous(memory_format=CL)
    assert all(t.is_contiguous(memory_format=CL) for t in d)
    params = [p for p in [*gen.parameters(), *disc.parameters()]
              if p.dim() == 4]
    grads = torch.autograd.grad(out.square().mean() + d[1].mean(), params)
    assert all(g.is_contiguous(memory_format=CL) for g in grads)


def _step(dtype, layout, shadow, every_k=1, dropout=True):
    gen, disc = _models(dtype, dropout=dropout)
    if layout is not None:
        to_layout((gen, disc), layout=layout)
    opts = (make_optimizer(gen.parameters(), every_k=every_k),
            make_optimizer(disc.parameters(), every_k=every_k))
    step = make_train_step(gen, disc, *opts, layout=layout,
                           shadow_dtype=dtype if shadow else None)
    return step, gen, disc, opts


def _state(gen, disc, opts):
    out = [*gen.parameters(), *disc.parameters()]
    for opt in opts:
        inner = getattr(opt, 'inner', opt)
        out += inner.mu + inner.nu + list(getattr(opt, 'acc', []))
    return [t.detach().clone() for t in out]


@pytest.mark.parametrize('every_k', [1, 2], ids=['adam', 'accumulate'])
@pytest.mark.parametrize('layout', [None, LAYOUT], ids=['nchw', 'cl'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
def test_shadow_step_bit_exact(dtype, layout, every_k):
    """The shadow step equals the plain step bit for bit over 3 steps
    (4 micro-steps accumulating): every loss, parameter and moment; the
    refreshed shadows equal the cast masters."""
    batches = _batches(4 if every_k == 2 else 3)
    runs = {}
    for shadow in (False, True):
        step, gen, disc, opts = _step(dtype, layout, shadow, every_k)
        losses = [{k: v.item() for k, v in step(x, y).items()}
                  for x, y in batches]
        runs[shadow] = (losses, _state(gen, disc, opts))
        if shadow:
            named = dict(gen.named_parameters())
            assert set(step.shadows) == set(named)
            for n, t in step.shadows.items():
                assert t.dtype == dtype
                assert torch.equal(t, named[n].detach().to(dtype))
                if layout is not None and t.dim() == 4:
                    assert t.is_contiguous(memory_format=CL)
        else:
            assert step.shadows is None
    assert runs[False][0] == runs[True][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[False][1],
                                                 runs[True][1]))


def test_shadows_are_separate_tensors():
    gen, _ = _models()
    shadows = make_shadows(gen, torch.float32)
    for n, p in gen.named_parameters():
        assert shadows[n].data_ptr() != p.data_ptr()
        assert not shadows[n].requires_grad


@pytest.mark.parametrize('maker', ['train', 'eval'])
def test_forms_without_channels_last_refuse(maker):
    gen, disc = _models()
    if maker == 'train':
        opts = (make_optimizer(gen.parameters()),
                make_optimizer(disc.parameters()))

        def make(**kw):
            return make_train_step(gen, disc, *opts, **kw)
    else:
        def make(**kw):
            return make_eval_step(gen, disc, **kw)
    with pytest.raises(ValueError, match='s2d.*ROADMAP'):
        make(layout=LAYOUT, s2d=True)
    with pytest.raises(ValueError, match='mesh.*ROADMAP'):
        make(layout=LAYOUT, mesh=object())
    with pytest.raises(ValueError, match='layout must be'):
        make(layout='nhwc')


def test_eval_step_in_channels_last_matches_nchw():
    gen, disc = _models()
    x, y = _batches(1)[0]
    want = make_eval_step(gen, disc, compute_iou=True)(x, y)
    to_layout((gen, disc))
    got = make_eval_step(gen, disc, compute_iou=True, layout=LAYOUT)(x, y)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)


def _trainer(tmp_path, dtype=torch.float32):
    from patchgan_tpu_torch.train import Trainer
    gen, disc = _models(dtype)
    return Trainer(gen, disc, str(tmp_path), seed=3)


@pytest.mark.parametrize('flags,dtype,layout,shadow', [
    ({}, torch.float32, LAYOUT, None),
    ({}, torch.bfloat16, LAYOUT, torch.bfloat16),
    ({'PATCHGAN_SHADOW_PARAMS': 'off'}, torch.bfloat16, LAYOUT, None),
    ({'PATCHGAN_AUTO_LAYOUT': 'off'}, torch.bfloat16, None, None),
], ids=['fp32', 'bf16', 'shadow-off', 'layout-off'])
def test_trainer_picks_layout_and_shadow(tmp_path, monkeypatch, flags, dtype,
                                         layout, shadow):
    """As the JAX Trainer's ``_auto_layout`` and ``_shadow_params`` pick
    them: the shadow only beside the layout and a compute dtype other
    than the fp32 masters'."""
    monkeypatch.delenv('PATCHGAN_S2D', raising=False)
    for k, v in flags.items():
        monkeypatch.setenv(k, v)
    t = _trainer(tmp_path, dtype)
    assert (t.layout, t.shadow_dtype) == (layout, shadow)
    fmt = CL if layout else torch.contiguous_format
    assert all(p.is_contiguous(memory_format=fmt)
               for p in t.generator.parameters())
    x, y = _batches(1)[0]
    losses = t.batch(x, y, train=True)
    assert all(np.isfinite(v) for v in losses.values())
    train_step = t._step_cache[2][False][0]
    assert (train_step.shadows is not None) == (shadow is not None)


def test_trainer_keeps_nchw_on_s2d_and_warns_once(tmp_path, monkeypatch):
    monkeypatch.setattr(auto_layout, '_warned', set())
    monkeypatch.setenv('PATCHGAN_S2D', 'on')
    monkeypatch.delenv('PATCHGAN_AUTO_LAYOUT', raising=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        first = _trainer(tmp_path / 'a')
        second = _trainer(tmp_path / 'b')
    said = [w for w in caught if 'channels_last' in str(w.message)]
    assert len(said) == 1 and 'PATCHGAN_S2D=on' in str(said[0].message)
    assert first.layout is None and second.layout is None
    assert all(p.is_contiguous() for p in first.generator.parameters())


def test_trainer_keeps_nchw_on_a_mesh_and_warns_once(tmp_path, monkeypatch):
    from patchgan_tpu_torch.train import Trainer
    monkeypatch.setattr(auto_layout, '_warned', set())
    monkeypatch.delenv('PATCHGAN_S2D', raising=False)

    class Mesh:
        is_main, capturable, backend = True, True, 'none'

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        for name in ('a', 'b'):
            gen, disc = _models()
            t = Trainer(gen, disc, str(tmp_path / name), mesh=Mesh())
            assert t.layout is None
    said = [w for w in caught if 'channels_last' in str(w.message)]
    assert len(said) == 1 and 'a mesh' in str(said[0].message)


def test_trainer_refreshes_shadows_after_writes(tmp_path):
    """``load`` and ``load_transfer_checkpoints`` write the masters; the
    train step's shadows follow them."""
    t = _trainer(tmp_path / 'a', torch.bfloat16)
    x, y = _batches(1)[0]
    t.batch(x, y, train=True)
    t.save(1)
    other = _trainer(tmp_path / 'b', torch.bfloat16)
    other.batch(x, y, train=True)
    shadows = other._step_cache[2][False][0].shadows
    for load in (lambda: other.load(f'{tmp_path}/a/generator_ep_001.npz',
                                    f'{tmp_path}/a/discriminator_ep_001.npz'),
                 lambda: other.load_transfer_checkpoints(
                     f'{tmp_path}/a/generator_ep_001.npz',
                     f'{tmp_path}/a/discriminator_ep_001.npz')):
        with torch.no_grad():
            for p in other.generator.parameters():
                p.add_(1.0)
        other._refresh_shadows()
        load()
        named = dict(t.generator.named_parameters())
        for n, s in shadows.items():
            assert torch.equal(s, named[n].detach().to(torch.bfloat16))


# the wrappers on CPU tensors: the plain versions keep the layout


def _cl(*ts):
    return [t.contiguous(memory_format=CL) for t in ts]


@pytest.mark.parametrize('act', ['relu', 'leakyrelu', 'tanh', None])
def test_wrappers_keep_channels_last_on_the_cpu(act):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 16, 8, 8, generator=g)
    w2 = torch.randn(24, 16, 4, 4, generator=g) * 0.1
    w3 = torch.randn(16 + 8, 12, 4, 4, generator=g) * 0.1
    skip = torch.randn(2, 8, 8, 8, generator=g)
    dy = torch.randn(2, 16, 8, 8, generator=g)
    cases = [(instance_norm_act, (x,), (1e-5, act)),
             (instance_norm_act_backward, (dy, x), (1e-5, act)),
             (conv_norm_act, (x, w2), (1e-5, act)),
             (convt_norm_act, (x, w3), (1e-5, act, skip))]
    for fn, tensors, rest in cases:
        want = fn(*tensors, *rest)
        got = fn(*_cl(*tensors), *[_cl(r)[0] if torch.is_tensor(r) else r
                                   for r in rest])
        assert got.is_contiguous(memory_format=CL), fn.__name__
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_autograd_keeps_channels_last_on_the_cpu():
    x = torch.randn(2, 16, 8, 8).contiguous(memory_format=CL)
    x.requires_grad_()
    w = (torch.randn(24, 16, 4, 4) * 0.1).contiguous(
        memory_format=CL).requires_grad_()
    y = conv_norm_act(x, w, 1e-5, 'relu')
    z = instance_norm_act(y, 1e-5, 'tanh')
    dx, dw = torch.autograd.grad(z.square().sum(), (x, w))
    assert y.is_contiguous(memory_format=CL)
    assert dx.is_contiguous(memory_format=CL)
    assert dw.is_contiguous(memory_format=CL)


def test_layout_detection():
    x = torch.randn(2, 8, 4, 4)
    assert not is_nhwc(x)
    assert is_nhwc(x.contiguous(memory_format=CL))
    # a tensor both layouts describe: its strides say which it was made as
    one = torch.randn(2, 8, 1, 1)
    assert not is_nhwc(one)
    assert is_nhwc(torch.empty_like(one, memory_format=CL).copy_(one))
    with pytest.raises(ValueError, match='neither'):
        is_nhwc(x.transpose(2, 3))
    g = torch.randn(2, 8, 4, 4)
    assert in_layout_of(g, x) is g
    moved = in_layout_of(g, x.contiguous(memory_format=CL))
    assert moved.is_contiguous(memory_format=CL) and torch.equal(moved, g)


def test_nhwc_pack_permutes_the_nchw_pack():
    """The NHWC form's packed weight holds the NCHW pack's values with k
    reordered from (ci, tap) to (tap, ci)."""
    w = torch.randn(13 + 6, 40, 4, 4)
    a, b = pack_convt_weight_plain(w), pack_convt_weight_nhwc_plain(w)
    c = w.shape[0]
    assert a.shape == b.shape == (4, 40, 96)
    nchw = a[:, :, :4 * c].reshape(4, 40, c, 4)
    nhwc = b[:, :, :4 * c].reshape(4, 40, 4, c)
    assert torch.equal(nchw, nhwc.transpose(2, 3))
    assert not b[:, :, 4 * c:].any()


@pytest.mark.parametrize('n,hw,c,width', [
    (16, 128 * 128, 64, 8), (16, 4, 512, 8), (1, 1, 3, 1), (16, 64 * 64, 128,
                                                            4)])
def test_nhwc_segments(n, hw, c, width):
    """Enough blocks to fill the card where the pixels allow, each thread
    at least four pixels, at least one segment."""
    segs = nhwc_segments(n, hw, c, width)
    chunks = -(-c // width)
    lanes = min(32, 1 << (chunks - 1).bit_length())
    tiles = -(-chunks // lanes)
    rows = 256 // lanes
    assert 1 <= segs <= max(1, -(-hw // (4 * rows)))
    if hw >= 4 * rows * 528:
        assert n * tiles * segs >= 528


def test_nhwc_plan_falls_back_to_elements():
    x = torch.empty(64)
    assert nhwc_plan(2, 16, 64, torch.bfloat16, x)[0]
    assert not nhwc_plan(2, 16, 60, torch.bfloat16, x)[0]
    assert not nhwc_plan(2, 16, 64, torch.bfloat16, x[1:])[0]
