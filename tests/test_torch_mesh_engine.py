"""The port's inference engine over a ``DeviceMesh`` of several devices
(CPU devices here, nf=8, 128-px tiles, fp32), against its one-device
engine (``predict_tiles`` and float masks within rtol 1e-5 / atol 1e-6,
label and bit-packed masks on >= 99.9% of pixels with equal dtypes, a
``predict_images`` group equal to single calls) and against the JAX
engine over a mesh of as many JAX CPU devices (masks on >= 99.9% of
pixels); spatial mode on a mesh runs split by rows, without a warning,
and equals the one-device mask, and where the padded height does not
split it warns and runs on the home device (``tests/
test_torch_spatial_engine.py`` holds the split mode to its limits); a
one-device mesh is ``mesh=None`` bit for bit;
``default_mesh()`` covers the visible cards."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchgan_tpu.inference import InferenceEngine as JaxEngine
from patchgan_tpu.models import UNet as JaxUNet
from patchgan_tpu.parallel.mesh import default_mesh as jax_default_mesh
from patchgan_tpu_torch.inference import InferenceEngine
from patchgan_tpu_torch.inference.engine import _pick_bucket
from patchgan_tpu_torch.inference.tiling import crop_positions
from patchgan_tpu_torch.models import UNet
from patchgan_tpu_torch.parallel import DeviceMesh, default_mesh
from patchgan_tpu_torch.utils.transfer import state_dict_from_jax

torch.set_num_threads(2)

SIZE, NF = 128, 8
RTOL, ATOL = 1e-5, 1e-6
# 2 devices split every power-of-two bucket; 3 split none, so buckets
# are the tile count rounded up to a multiple of 24
MESHES = [2, 3]
KINDS = {'argmax': (3, 'softmax', 0), 'packed-threshold': (1, 'sigmoid', 0.5),
         'float': (1, 'sigmoid', 0)}


def _images():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, (300, 200, 3), dtype=np.uint8),
            rng.integers(0, 256, (100, 90, 3), dtype=np.uint8),
            rng.random((150, 260, 3), dtype=np.float32)]


def _engines(k, kind, seed=0):
    classes, final_act, threshold = KINDS[kind]
    model = UNet(3, classes, nf=NF, activation='relu', final_act=final_act,
                 generator=torch.Generator().manual_seed(seed))
    kw = dict(size=SIZE, overlap=0.9, threshold=threshold,
              dtype=torch.float32)
    return (InferenceEngine(model, device='cpu', **kw),
            InferenceEngine(model, mesh=default_mesh(['cpu'] * k), **kw))


@pytest.mark.parametrize('k', MESHES)
def test_predict_tiles_matches_one_device(k):
    one, mesh = _engines(k, 'argmax')
    assert mesh.n_devices == k and mesh.batch_size % k == 0
    crops = np.random.default_rng(3).random((7, SIZE, SIZE, 3),
                                            dtype=np.float32)
    got = mesh.predict_tiles(crops)
    assert got.shape == (7, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, one.predict_tiles(crops), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('k', MESHES)
def test_float_masks_match_one_device(k):
    one, mesh = _engines(k, 'float')
    for im in _images():
        got, want = mesh.predict_image(im), one.predict_image(im)
        assert got.shape == im.shape[:2] and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('kind', ['argmax', 'packed-threshold'])
@pytest.mark.parametrize('k', MESHES)
def test_label_masks_match_one_device(k, kind):
    one, mesh = _engines(k, kind)
    for im in _images():
        got, want = mesh.predict_image(im), one.predict_image(im)
        assert got.shape == im.shape[:2] and got.dtype == want.dtype
        assert np.mean(got == want) >= 0.999


@pytest.mark.parametrize('k', MESHES)
def test_group_equals_single_calls(k):
    """A group's tiles share mesh-wide buckets; each image's mask equals
    its own call's."""
    _, mesh = _engines(k, 'float')
    images = _images()
    group = mesh.predict_images(images)
    for g, im in zip(group, images):
        want = mesh.predict_image(im)
        assert g.shape == want.shape and g.dtype == want.dtype
        np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('k', MESHES)
def test_matches_jax_mesh_engine(k):
    """The same weights through the JAX engine over k JAX CPU devices.
    Its buckets align to max(8, devices), and on 3 devices no power of
    two divides: a cap below 8 (batch_size 6) takes its fallback bucket,
    which does."""
    jmodel = JaxUNet(input_nc=3, output_nc=3, nf=NF, activation='relu',
                     final_act='softmax')
    params = jax.device_get(jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((1, SIZE, SIZE, 3))))(jax.random.PRNGKey(2))['params'])
    jeng = JaxEngine(jmodel, params, size=SIZE, overlap=0.9, batch_size=6,
                     mesh=jax_default_mesh(jax.devices()[:k]))
    peng = InferenceEngine(UNet(3, 3, nf=NF, activation='relu',
                                final_act='softmax'),
                           state_dict_from_jax(params), size=SIZE,
                           overlap=0.9, dtype=torch.float32,
                           mesh=default_mesh(['cpu'] * k))
    images = _images()
    got = peng.predict_images(images)
    want = jeng.predict_images(images)
    for g, w, im in zip(got, want, images):
        assert g.shape == im.shape[:2] and g.dtype == w.dtype
        assert np.mean(g == w) >= 0.999


def test_spatial_on_a_mesh_warns_and_runs_on_home():
    """On 2 devices the 300 x 200 image (padded 384 rows) runs split by
    rows, without a warning, its labels equal to one device's on >= 99.9%
    of pixels; on 3 devices the 150 x 260 image (padded 256 rows, which do
    not split into 3 even bands) warns, once an engine, and runs on the
    home device, bit-equal to one device."""
    one, mesh = _engines(2, 'argmax')
    im = _images()[0]
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        got = mesh.predict_image(im, mode='spatial')
    want = one.predict_image(im, mode='spatial')
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.mean(got == want) >= 0.999
    _, mesh3 = _engines(3, 'argmax')
    im = _images()[2]
    with pytest.warns(UserWarning, match='does not split'):
        got = mesh3.predict_image(im, mode='spatial')
    np.testing.assert_array_equal(got, one.predict_image(im, mode='spatial'))
    with warnings.catch_warnings():
        warnings.simplefilter('error')      # once an engine
        mesh3.predict_image(im, mode='spatial')


def test_one_device_mesh_is_mesh_none():
    model = UNet(3, 3, nf=NF, activation='relu', final_act='softmax',
                 generator=torch.Generator().manual_seed(5))
    kw = dict(size=SIZE, dtype=torch.float32)
    plain = InferenceEngine(model, device='cpu', **kw)
    mesh = InferenceEngine(model, mesh=default_mesh(['cpu']), **kw)
    assert (mesh.device, mesh.batch_size) == (plain.device, plain.batch_size)
    images = _images()
    crops = np.random.default_rng(4).random((5, SIZE, SIZE, 3),
                                            dtype=np.float32)
    np.testing.assert_array_equal(mesh.predict_tiles(crops),
                                  plain.predict_tiles(crops))
    for g, w in zip(mesh.predict_images(images), plain.predict_images(images)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('count', [1, 4])
def test_default_mesh_covers_the_visible_cards(count, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: count)
    mesh = default_mesh()
    assert list(mesh) == [torch.device('cuda', i) for i in range(count)]
    assert mesh.home == torch.device('cuda', 0)
    assert mesh.describe() == ('1 device: cuda:0' if count == 1 else
                               '4 devices: cuda:0..cuda:3')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='none is available'):
        default_mesh()


def test_mesh_arguments_are_checked():
    model = UNet(3, 1, nf=4)
    with pytest.raises(TypeError, match='DeviceMesh'):
        InferenceEngine(model, size=SIZE, mesh=['cpu', 'cpu'])
    with pytest.raises(ValueError, match='first device'):
        InferenceEngine(model, size=SIZE, device='cuda',
                        mesh=DeviceMesh(['cpu', 'cpu']))
    with pytest.raises(ValueError, match='at least one'):
        DeviceMesh([])


@pytest.mark.parametrize('align', [1, 2, 3, 4])
def test_buckets_are_multiples_of_the_mesh(align):
    cap = -(-128 // align) * align
    for n in (1, 3, 30, 130):
        bs = _pick_bucket(n, cap, align)
        assert bs % align == 0 and bs <= cap


def test_tiled_forwards_take_one_k_split(monkeypatch):
    """Every tiled forward (a whole bucket on one device, each share on
    a mesh) runs the UNet at the fused kernels' K split of SPLIT_BATCH
    tiles, so a tile's bits do not depend on its bucket or share (the
    kernels decide this on the card; the plain CPU path has no split);
    the whole-image forward keeps its own, split by rows on a mesh: one
    call a device, each on its band."""
    from patchgan_tpu_torch.inference.engine import SPLIT_BATCH
    seen = []
    forward = UNet.forward

    def spy(self, x, *args, **kwargs):
        seen.append((x.shape[0], kwargs.get('split_batch')))
        return forward(self, x, *args, **kwargs)

    monkeypatch.setattr(UNet, 'forward', spy)
    one, mesh = _engines(2, 'argmax')
    im = _images()[0]
    tiles = len(crop_positions(*im.shape[:2], SIZE, 0.9))
    for eng in (one, mesh):
        seen.clear()
        eng.predict_image(im)
        bucket = _pick_bucket(tiles, eng.batch_size, eng.n_devices)
        assert seen == [(bucket // eng.n_devices, SPLIT_BATCH)] * (
            -(-tiles // bucket) * eng.n_devices)
    seen.clear()
    one.predict_image(im, mode='spatial')
    assert seen == [(1, None)]
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        seen.clear()
        mesh.predict_image(im, mode='spatial')
    assert seen == [(1, None)] * mesh.n_devices
