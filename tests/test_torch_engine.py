"""The port's tiling and inference engine against the JAX package's:
tiling functions equal; engine masks (fp32, 128-px tiles, nf=8, weights
carried across from JAX) agree on >= 99.9% of pixels, for multi-class
argmax and for a bit-packed binary threshold."""

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
    eng = InferenceEngine(model, size=SIZE, device='cpu')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        eng.predict_image(np.zeros((SIZE, SIZE, 3), np.uint8),
                          mode='spatial')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        InferenceEngine(model, size=SIZE, device='cpu', mesh=object())
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no GPU'):
        InferenceEngine(model, size=SIZE)
