"""The port's tiling and inference engine against the JAX package's:
tiling functions equal; engine masks (fp32, 128-px tiles, nf=8, weights
carried across from JAX) agree on >= 99.9% of pixels, for multi-class
argmax and for a bit-packed binary threshold; the whole-image spatial
mode against the JAX engine's spatial mode (labels, packed threshold,
probabilities within 1e-4); int64 labels above 256 classes; the bucket
table read from its file."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchgan_tpu.inference import InferenceEngine as JaxEngine
from patchgan_tpu.inference import tiling as jax_tiling
from patchgan_tpu.models import UNet as JaxUNet
from patchgan_tpu_torch.inference import InferenceEngine, tiling
from patchgan_tpu_torch.models import UNet
from patchgan_tpu_torch.utils.transfer import state_dict_from_jax

torch.set_num_threads(2)

SIZE, NF = 128, 8


@pytest.mark.parametrize('hw', [(128, 128), (300, 200), (200, 300),
                                (1000, 130), (129, 257)])
@pytest.mark.parametrize('overlap', [0.9, 0.5])
def test_tiling_matches_jax(hw, overlap):
    h, w = hw
    assert tiling.crop_positions(h, w, SIZE, overlap) == \
        jax_tiling.crop_positions(h, w, SIZE, overlap)
    rng = np.random.default_rng(0)
    image = rng.random((h, w, 3), dtype=np.float32)
    crops = tiling.n_crop(image, SIZE, overlap)
    np.testing.assert_array_equal(
        crops, jax_tiling.n_crop(image, SIZE, overlap))
    masks = rng.random(crops.shape[:3] + (4,), dtype=np.float32)
    for threshold in (0, 0.5):
        np.testing.assert_array_equal(
            tiling.build_mask(masks, SIZE, (h, w), threshold, overlap),
            jax_tiling.build_mask(masks, SIZE, (h, w), threshold, overlap))


def _images():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, (300, 200, 3), dtype=np.uint8),
            rng.integers(0, 256, (100, 90, 3), dtype=np.uint8)]


@pytest.mark.parametrize('classes,final_act,threshold',
                         [(3, 'softmax', 0), (1, 'sigmoid', 0.5)],
                         ids=['argmax', 'packed-threshold'])
def test_engine_matches_jax(classes, final_act, threshold):
    jmodel = JaxUNet(input_nc=3, output_nc=classes, nf=NF,
                     activation='relu', final_act=final_act)
    params = jax.device_get(jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, SIZE, SIZE, 3))))(jax.random.PRNGKey(2))['params'])
    model = UNet(3, classes, nf=NF, activation='relu', final_act=final_act)
    jeng = JaxEngine(jmodel, params, size=SIZE, overlap=0.9,
                     threshold=threshold)
    peng = InferenceEngine(model, state_dict_from_jax(params), size=SIZE,
                           overlap=0.9, threshold=threshold,
                           dtype=torch.float32, device='cpu')
    images = _images()
    got = peng.predict_images(images)
    want = jeng.predict_images(images)
    for g, w, im in zip(got, want, images):
        assert g.shape == im.shape[:2] and g.dtype == w.dtype
        assert np.mean(g == w) >= 0.999
    if threshold:
        assert set(np.unique(got[0])) <= {0.0, 1.0}


def test_predict_tiles_and_bucket_padding():
    """predict_tiles pads to a bucket and returns only the real tiles,
    each equal to a direct forward."""
    model = UNet(3, 2, nf=4, generator=torch.Generator().manual_seed(0))
    eng = InferenceEngine(model, size=SIZE, batch_size=8, device='cpu')
    crops = np.random.default_rng(3).random((3, SIZE, SIZE, 3),
                                            dtype=np.float32)
    out = eng.predict_tiles(crops)
    assert out.shape == (3, SIZE, SIZE, 2)
    with torch.no_grad():
        ref = model.eval()(torch.from_numpy(crops).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out, ref.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_unported_modes_and_missing_gpu_raise(monkeypatch):
    model = UNet(3, 1, nf=4)
    with pytest.raises(TypeError, match='DeviceMesh'):
        InferenceEngine(model, size=SIZE, device='cpu', mesh=object())
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no GPU'):
        InferenceEngine(model, size=SIZE)


@pytest.mark.parametrize('classes,final_act,threshold',
                         [(3, 'softmax', 0), (1, 'sigmoid', 0.5),
                          (1, 'sigmoid', 0)],
                         ids=['argmax', 'packed-threshold', 'probabilities'])
def test_spatial_matches_jax(classes, final_act, threshold):
    """mode='spatial' on the same weights as the JAX engine's spatial
    mode: equal shape and dtype; labels and the packed binary mask on >=
    99.9% of pixels, probabilities within 1e-4."""
    jmodel = JaxUNet(input_nc=3, output_nc=classes, nf=NF,
                     activation='relu', final_act=final_act)
    params = jax.device_get(jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, SIZE, SIZE, 3))))(jax.random.PRNGKey(4))['params'])
    model = UNet(3, classes, nf=NF, activation='relu', final_act=final_act)
    jeng = JaxEngine(jmodel, params, size=SIZE, threshold=threshold)
    peng = InferenceEngine(model, state_dict_from_jax(params), size=SIZE,
                           threshold=threshold, dtype=torch.float32,
                           device='cpu')
    for im in _images():
        got = peng.predict_image(im, mode='spatial')
        want = jeng.predict_image(im, mode='spatial')
        assert got.shape == want.shape == im.shape[:2]
        assert got.dtype == want.dtype
        if classes == 1 and not threshold:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        else:
            assert np.mean(got == want) >= 0.999
        if threshold:
            assert set(np.unique(got)) <= {0.0, 1.0}


def test_spatial_uint8_and_float32_ingest():
    """uint8 is divided by 255 on the device: the same image as uint8 and
    as float32 / 255 gives the same spatial probabilities."""
    model = UNet(3, 1, nf=4, final_act='sigmoid',
                 generator=torch.Generator().manual_seed(6))
    eng = InferenceEngine(model, size=SIZE, device='cpu')
    im = _images()[0]
    np.testing.assert_allclose(
        eng.predict_image(im, mode='spatial'),
        eng.predict_image(im.astype(np.float32) / 255.0, mode='spatial'),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize('mode', ['tiled', 'spatial'])
def test_more_than_256_classes_give_int64_labels(mode):
    """300 classes: labels stay int64 on the device (no uint8 wrap) and
    equal the argmax of the direct forward (spatial) or of the stitched
    tiles (tiled)."""
    model = UNet(3, 300, nf=4, final_act='softmax',
                 generator=torch.Generator().manual_seed(7))
    eng = InferenceEngine(model, size=SIZE, device='cpu')
    im = np.random.default_rng(8).random((150, 140, 3), dtype=np.float32)
    got = eng.predict_image(im, mode=mode)
    assert got.dtype == np.int64 and got.shape == (150, 140)
    if mode == 'spatial':
        x = np.zeros((256, 256, 3), np.float32)
        x[:150, :140] = im
        with torch.no_grad():
            probs = model.eval()(torch.from_numpy(x).permute(2, 0, 1)[None])
        want = probs[0, :, :150, :140].argmax(0).numpy()
    else:
        crops = tiling.n_crop(im, SIZE, 0.9)
        want = tiling.build_mask(eng.predict_tiles(crops), SIZE, (150, 140),
                                 0, 0.9)
    assert got.max() > 255
    assert np.mean(got == want) >= 0.999


@pytest.mark.parametrize('source', ['file', 'env', 'unreadable'])
def test_bucket_table_from_file(source, tmp_path, monkeypatch):
    """_load_bucket_rates reads rel_rate from bucket_rates.json beside the
    engine or from the file PATCHGAN_BUCKET_RATES names; a missing or
    unreadable file gives the uniform table. _pick_bucket's cost rule
    then picks by padded tiles / rate."""
    import json

    from patchgan_tpu_torch.inference import engine as eng_mod
    if source == 'file':
        path = os.path.join(os.path.dirname(eng_mod.__file__),
                            'bucket_rates.json')
        monkeypatch.delenv('PATCHGAN_BUCKET_RATES', raising=False)
        if not os.path.exists(path):
            assert eng_mod._load_bucket_rates() == \
                eng_mod._FALLBACK_BUCKET_REL_RATE
            return
        with open(path) as f:
            doc = json.load(f)
        want = {int(k): float(v) for k, v in doc['rel_rate'].items()}
        assert doc['rel_rate']['16'] == 1.0
        assert {'device', 'date', 'size', 's2d', 'dtype',
                'img_s'} <= set(doc)
    elif source == 'env':
        path = tmp_path / 'rates.json'
        want = {1: 0.1, 2: 0.2, 4: 0.4, 8: 0.7, 16: 1.0, 32: 1.5}
        path.write_text(json.dumps(
            {'rel_rate': {str(k): v for k, v in want.items()}}))
        monkeypatch.setenv('PATCHGAN_BUCKET_RATES', str(path))
    else:
        path = tmp_path / 'rates.json'
        path.write_text('{not json')
        monkeypatch.setenv('PATCHGAN_BUCKET_RATES', str(path))
        want = eng_mod._FALLBACK_BUCKET_REL_RATE
    rates = eng_mod._load_bucket_rates()
    assert rates == want
    monkeypatch.setattr(eng_mod, '_BUCKET_REL_RATE', rates)
    for n in (1, 3, 30, 130):
        costs = {b: -(-n // b) * b / r for b, r in rates.items() if b <= 128}
        assert eng_mod._pick_bucket(n, 128) == min(costs, key=costs.get)
