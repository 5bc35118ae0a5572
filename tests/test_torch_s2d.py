"""The port's space-to-depth (s2d) boundary form against the JAX package's.

Same inputs (numpy, seeded) through both packages, NHWC / HWIO on the JAX
side and NCHW with torch weight layouts on the port's; weights written
once by the JAX package and read by both. The JAX models run with their
plain (non-Pallas) reference ops; the thin-conv kernel itself is held to
the JAX Pallas kernel in test_torch_kernels.py. Tolerances: fp32 rtol
1e-3 / atol 1e-4, bf16 atol 3e-2; step losses rtol 2e-3 / atol 2e-4 and
parameters within Adam's step-1 sign-flip bound
(tests/test_train_step_parity.py:109-129); dropout off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from patchgan_tpu.inference import InferenceEngine as JaxEngine
from patchgan_tpu.models import Discriminator as JaxDisc
from patchgan_tpu.models import UNet as JaxUNet
from patchgan_tpu.ops import s2d as JS
from patchgan_tpu.train.steps import make_eval_step as jax_make_eval_step
from patchgan_tpu.utils import checkpoint as jax_ckpt
from patchgan_tpu.utils.transfer import (conv_kernel_to_jax,
                                         convT_kernel_to_jax, disc_key_map,
                                         export_state_dict, unet_key_map)
from patchgan_tpu_torch.inference import InferenceEngine
from patchgan_tpu_torch.models import Discriminator, UNet
from patchgan_tpu_torch.ops import s2d as S
from patchgan_tpu_torch.ops.conv import conv2d, conv_transpose2d
from patchgan_tpu_torch.ops.kernels import thin_conv as K4
from patchgan_tpu_torch.train.steps import (make_eval_step, make_optimizer,
                                            make_train_step)
from patchgan_tpu_torch.utils.checkpoint import load_state_dict

torch.set_num_threads(2)

DTYPES = [('float32', torch.float32, jnp.float32),
          ('bfloat16', torch.bfloat16, jnp.bfloat16)]


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (0, 3, 1, 2)))).to(dtype)


def _nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    if name == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)


# ---------------------------------------------------------------- ops

def test_layout_ops_match_jax():
    """space_to_depth / depth_to_space equal JAX's after NHWC -> NCHW;
    fold_blocks keeps JAX's per-(sample, class) pixel multisets;
    apply_activation_s2d equals JAX's for softmax and sigmoid."""
    a = _np((2, 8, 10, 3), 0)
    got = S.space_to_depth(_nchw(a))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(
        JS.space_to_depth(jnp.asarray(a))))
    assert torch.equal(S.depth_to_space(got), _nchw(a))
    s = _np((2, 4, 5, 12), 1)
    folded = S.fold_blocks(_nchw(s)).numpy()
    jf = np.asarray(JS.fold_blocks(jnp.asarray(s)))
    for n in range(2):
        for c in range(3):
            np.testing.assert_array_equal(np.sort(folded[n, c].ravel()),
                                          np.sort(jf[n, :, :, c].ravel()))
    for act in ('softmax', 'sigmoid'):
        np.testing.assert_allclose(
            _nhwc(S.apply_activation_s2d(_nchw(s), act)),
            np.asarray(JS.apply_activation_s2d(jnp.asarray(s), act)),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('dt', DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize('form', ['plain', 'x2', 'x2s', 'bias'])
def test_conv2d_s2d_matches_jax(form, dt):
    """conv2d_s2d against JAX's and against the port's own stride-2
    conv2d of the full-resolution input; 3 -> 8 channels plus a 2-channel
    second input (x2, or x2s with two masks)."""
    name, tdt, jdt = dt
    cin, c2, cout = 3, (2 if form in ('x2', 'x2s') else 0), 8
    # weights scaled for O(1) outputs: one bf16 rounding stays in 3e-2
    x, w = _np((2, 16, 12, cin), 2), _np((cout, cin + c2, 4, 4), 3, 0.15)
    ms = [_np((2, 16, 12, c2), 4 + i) for i in range(2)] if c2 else []
    b = _np((cout,), 6, 0.5) if form == 'bias' else None
    jx = JS.space_to_depth(jnp.asarray(x, jdt))
    jms = [JS.space_to_depth(jnp.asarray(m, jdt)) for m in ms]
    jw = jnp.asarray(conv_kernel_to_jax(w), jdt)
    jb = jnp.asarray(b, jdt) if b is not None else None
    tx = S.space_to_depth(_nchw(x, tdt))
    tms = [S.space_to_depth(_nchw(m, tdt)) for m in ms]
    tw = torch.from_numpy(w).to(tdt)
    tb = torch.from_numpy(b).to(tdt) if b is not None else None
    if form == 'x2s':
        want = JS.conv2d_s2d(jx, jw, x2s=tuple(jms))
        got = S.conv2d_s2d(tx, tw, x2s=tuple(tms))
        ref = [conv2d(_nchw(x, tdt), tw, x2=_nchw(m, tdt)) for m in ms]
    else:
        x2 = tms[0] if tms else None
        want = [JS.conv2d_s2d(jx, jw, bias=jb, x2=jms[0] if jms else None)]
        got = [S.conv2d_s2d(tx, tw, bias=tb, x2=x2)]
        ref = [conv2d(_nchw(x, tdt), tw, bias=tb,
                      x2=_nchw(ms[0], tdt) if ms else None)]
    assert len(got) == len(want) == len(ref)
    for g, wnt, r in zip(got, want, ref):
        assert g.dtype == tdt and g.shape == (2, cout, 8, 6)
        _close(_nhwc(g), wnt, name)
        _close(_nhwc(g), _nhwc(r), name)


@pytest.mark.parametrize('dt', DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize('form', ['plain', 'x2', 'bias'])
def test_conv_transpose2d_s2d_matches_jax(form, dt):
    """conv_transpose2d_s2d (unflipped IOHW weight) against JAX's
    (pre-flipped HWIO) and against space_to_depth of the port's
    conv_transpose2d; 8 (+ 4 skip) -> 3 channels on a 6 x 10 input."""
    name, tdt, jdt = dt
    cin, c2, cout = 8, (4 if form == 'x2' else 0), 3
    x, w = _np((2, 6, 10, cin), 7), _np((cin + c2, cout, 4, 4), 8, 0.15)
    s = _np((2, 6, 10, c2), 9) if c2 else None
    b = _np((cout,), 10, 0.5) if form == 'bias' else None
    want = JS.conv_transpose2d_s2d(
        jnp.asarray(x, jdt), jnp.asarray(convT_kernel_to_jax(w), jdt),
        bias=jnp.asarray(b, jdt) if b is not None else None,
        x2=jnp.asarray(s, jdt) if c2 else None)
    tw = torch.from_numpy(w).to(tdt)
    tb = torch.from_numpy(b).to(tdt) if b is not None else None
    ts = _nchw(s, tdt) if c2 else None
    got = S.conv_transpose2d_s2d(_nchw(x, tdt), tw, bias=tb, x2=ts)
    assert got.dtype == tdt and got.shape == (2, 4 * cout, 6, 10)
    _close(_nhwc(got), want, name)
    ref = conv_transpose2d(_nchw(x, tdt), tw, x2=ts)
    if tb is not None:
        ref = ref + tb.view(1, -1, 1, 1)
    _close(_nhwc(got), _nhwc(S.space_to_depth(ref)), name)


def test_thin_dispatch(monkeypatch):
    """_conv3 takes the thin-conv wrapper up to 32 input channels and a
    cuDNN conv above (the dec6 head's two convs, Cin = nf = 64 at
    nf=64)."""
    calls = []
    orig = K4._forward

    def spy(x, w):
        calls.append(x.shape[1])
        return orig(x, w)
    monkeypatch.setattr(K4, '_forward', spy)
    for cin in (4, 32, 33, 64):
        S._conv3(torch.zeros(1, cin, 4, 4), torch.zeros(2, cin, 3, 3))
    assert calls == [4, 32]


# ------------------------------------------------------------- models

SIZE, NF = 128, 8


@pytest.fixture(scope='module')
def jax_weights(tmp_path_factory):
    """A JAX-initialised UNet (3 -> 3 classes) and Discriminator, written
    to npz by the JAX package and read back by the port."""
    d = tmp_path_factory.mktemp('w')
    gen = JaxUNet(input_nc=3, output_nc=3, nf=NF, activation='relu',
                  final_act='softmax', use_pallas=False)
    disc = JaxDisc(input_nc=6, ndf=NF, n_layers=3, use_pallas=False)
    x = jnp.zeros((1, SIZE, SIZE, 3))
    gp = jax.device_get(jax.jit(lambda k: gen.init(k, x))(
        jax.random.PRNGKey(0))['params'])
    dp = jax.device_get(jax.jit(lambda k: disc.init(
        k, x, jnp.zeros((1, SIZE, SIZE, 3))))(jax.random.PRNGKey(1))
        ['params'])
    jax_ckpt.save_state_dict(str(d / 'g.npz'),
                             export_state_dict(gp, unet_key_map()))
    jax_ckpt.save_state_dict(str(d / 'd.npz'),
                             export_state_dict(dp, disc_key_map(3, False)))
    g = UNet(3, 3, nf=NF, activation='relu', final_act='softmax')
    g.load_state_dict(load_state_dict(str(d / 'g.npz')))
    dm = Discriminator(6, ndf=NF, n_layers=3)
    dm.load_state_dict(load_state_dict(str(d / 'd.npz')))
    return gen, gp, disc, dp, g.eval(), dm


def test_unet_s2d_matches_jax(jax_weights):
    """The port's UNet in s2d form against JAX UNet(s2d=True) and against
    its own plain form, fp32."""
    jgen, gp, _, _, gen, _ = jax_weights
    x = np.random.default_rng(11).random((2, SIZE, SIZE, 3),
                                         dtype=np.float32)
    want = jgen.clone(s2d=True).apply({'params': gp},
                                      JS.space_to_depth(jnp.asarray(x)))
    with torch.no_grad():
        got = gen(S.space_to_depth(_nchw(x)), s2d=True)
        plain = gen(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (2, 12, 64, 64)
    _close(_nhwc(got), want, 'float32')
    _close(_nhwc(S.depth_to_space(got)), _nhwc(plain), 'float32')


@pytest.mark.parametrize('paired', [False, True], ids=['single', 'paired'])
def test_discriminator_s2d_matches_jax(jax_weights, paired):
    """The Discriminator in s2d form, with one mask or a pair of masks,
    against JAX Discriminator(s2d=True) and against the port's plain
    form, fp32; the paired outputs equal separate calls."""
    _, _, jdisc, dp, _, disc = jax_weights
    rng = np.random.default_rng(12)
    x = rng.random((2, SIZE, SIZE, 3), dtype=np.float32)
    ys = [rng.random((2, SIZE, SIZE, 3), dtype=np.float32) for _ in range(2)]
    jx = JS.space_to_depth(jnp.asarray(x))
    jys = [JS.space_to_depth(jnp.asarray(y)) for y in ys]
    tx = S.space_to_depth(_nchw(x))
    tys = [S.space_to_depth(_nchw(y)) for y in ys]
    js2d = jdisc.clone(s2d=True)
    if paired:
        want = js2d.apply({'params': dp}, jx, tuple(jys))
        got = disc(tx, tuple(tys), s2d=True)
        plain = disc(_nchw(x), tuple(_nchw(y) for y in ys))
    else:
        want = [js2d.apply({'params': dp}, jx, jys[0])]
        got = [disc(tx, tys[0], s2d=True)]
        plain = [disc(_nchw(x), _nchw(ys[0]))]
    assert len(got) == len(want) == len(plain)
    for i, (g, w, p) in enumerate(zip(got, want, plain)):
        assert g.shape == (2, 1, 14, 14)
        _close(_nhwc(g), w, 'float32')
        _close(_nhwc(g), _nhwc(p), 'float32')
        _close(_nhwc(g), _nhwc(disc(_nchw(x), _nchw(ys[i]))), 'float32')


# ---------------------------------------------------------- steps

@pytest.mark.parametrize('steps', [1, 4])
def test_s2d_train_step_matches_jax(steps):
    """The s2d train step (paired discriminator) against JAX
    make_train_step on s2d clones: nf=4, batch 2, 128 px, relu, 3
    classes, softmax head, tversky * 200 + BCE."""
    jl, pl, first = torch_parity.run(128, 'relu', 3, 'softmax', steps,
                                     s2d=True)
    torch_parity.assert_losses_close(jl, pl)
    jg, jd, tg, td = first
    torch_parity.assert_params_close(jg, tg)
    torch_parity.assert_params_close(jd, td)


def test_s2d_eval_step_matches_jax():
    """The s2d eval step with IoU (merged discriminator) against JAX
    make_eval_step on s2d clones, and against the port's plain eval
    step."""
    state, _ = torch_parity.jax_case(128, 'relu', 3, 'softmax', True)
    gen, disc = torch_parity.port_models(state, 'relu', 3, 'softmax')
    jgen = JaxUNet(input_nc=3, output_nc=3, nf=torch_parity.NF,
                   activation='relu', final_act='softmax', s2d=True,
                   use_pallas=False)
    jdisc = JaxDisc(input_nc=6, ndf=torch_parity.NF, n_layers=3, s2d=True,
                    use_pallas=False)
    x, y = torch_parity.batches(128, 3, 1, seed=5)[0]
    want = jax_make_eval_step(jgen, jdisc, seg_alpha=200.0,
                              compute_iou=True)(state, x, y)
    got = make_eval_step(gen, disc, seg_alpha=200.0, compute_iou=True,
                         s2d=True)(torch_parity.nchw(x), torch_parity.nchw(y))
    plain = make_eval_step(gen, disc, seg_alpha=200.0, compute_iou=True)(
        torch_parity.nchw(x), torch_parity.nchw(y))
    assert set(got) == set(want) == set(plain)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=2e-3, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(float(got[k]), float(plain[k]),
                                   rtol=2e-3, atol=2e-4, err_msg=k)


def test_s2d_step_kernel_calls(monkeypatch):
    """One s2d train step reaches the thin conv 8 times and its weight
    gradient 6 times at nf=4: enc0, the dec6 head's two convs (Cin = nf,
    thin here; at nf=64 cuDNN runs them, chip_smoke.py counts 6 and 4),
    the fake conv0's two parts inside G's loss and the paired D step's
    shared image part and two mask parts; dw of enc0, of the head and of
    the D step's three parts. The discriminator's weights are constants
    in G's loss, so no weight gradient of D is computed there (2 more
    otherwise)."""
    counts = {'fwd': 0, 'wgrad': 0}
    fwd, wgrad = K4._forward, K4.thin_conv3x3_wgrad

    def count_fwd(x, w):
        counts['fwd'] += 1
        return fwd(x, w)

    def count_wgrad(x, dy):
        counts['wgrad'] += 1
        return wgrad(x, dy)
    monkeypatch.setattr(K4, '_forward', count_fwd)
    monkeypatch.setattr(K4, 'thin_conv3x3_wgrad', count_wgrad)
    init = torch.Generator().manual_seed(13)
    gen = UNet(3, 3, nf=4, generator=init)
    disc = Discriminator(6, ndf=4, n_layers=3, generator=init)
    step = make_train_step(gen, disc, make_optimizer(gen.parameters()),
                           make_optimizer(disc.parameters()), s2d=True)
    x, y = torch_parity.batches(128, 3, 1, seed=6)[0]
    losses = step(torch_parity.nchw(x), torch_parity.nchw(y))
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert counts == {'fwd': 8, 'wgrad': 6}
    assert all(p.requires_grad for p in disc.parameters())


# ---------------------------------------------------------- engine

def test_s2d_engine_matches_jax(jax_weights, monkeypatch):
    """The engine's s2d tiled forward (PATCHGAN_S2D=on) against the JAX
    engine's on one non-square image, fp32: >= 99.9% equal labels, and
    the same labels as the port's plain engine."""
    jgen, gp, _, _, gen, _ = jax_weights
    image = np.random.default_rng(14).integers(0, 256, (300, 200, 3),
                                               dtype=np.uint8)
    monkeypatch.setenv('PATCHGAN_S2D', 'on')
    jeng = JaxEngine(jgen, gp, size=SIZE, overlap=0.9)
    peng = InferenceEngine(gen, size=SIZE, overlap=0.9, dtype=torch.float32,
                           device='cpu')
    assert jeng._s2d and peng._s2d
    got, want = peng.predict_image(image), jeng.predict_image(image)
    monkeypatch.setenv('PATCHGAN_S2D', 'off')
    plain = InferenceEngine(gen, size=SIZE, overlap=0.9, device='cpu',
                            dtype=torch.float32)
    assert not plain._s2d
    assert got.shape == want.shape == image.shape[:2]
    assert np.mean(got == want) >= 0.999
    np.testing.assert_array_equal(got, plain.predict_image(image))
    monkeypatch.setenv('PATCHGAN_S2D', 'on')
    assert not InferenceEngine(gen, size=SIZE - 1, device='cpu')._s2d


@pytest.mark.parametrize('s2d', [False, True], ids=['plain', 's2d'])
def test_paired_and_separate_disc_steps_agree(s2d, monkeypatch):
    """PATCHGAN_PAIRED_DISC=off gives the discriminator step two separate
    forwards in place of the paired form; both give the same losses and
    updates (the forward is the same, the image part's weight gradient is
    summed in another order)."""
    x, y = torch_parity.batches(128, 3, 1, seed=7)[0]
    out = {}
    for flag in ('on', 'off'):
        monkeypatch.setenv('PATCHGAN_PAIRED_DISC', flag)
        init = torch.Generator().manual_seed(15)
        gen = UNet(3, 3, nf=4, generator=init)
        disc = Discriminator(6, ndf=4, n_layers=3, generator=init)
        step = make_train_step(gen, disc, make_optimizer(gen.parameters()),
                               make_optimizer(disc.parameters()), s2d=s2d)
        losses = step(torch_parity.nchw(x), torch_parity.nchw(y))
        out[flag] = ({k: float(v) for k, v in losses.items()},
                     {k: v.clone() for k, v in disc.state_dict().items()})
    for k, v in out['on'][0].items():
        np.testing.assert_allclose(out['off'][0][k], v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    torch_parity.assert_params_close(
        {k: v for k, v in out['on'][1].items()}, out['off'][1])
