"""The port's inference engine in spatial mode over a ``DeviceMesh`` of k
CPU devices (nf=8, fp32), where each device runs the generator's band
forward on its band of the padded image's rows
(``parallel.spatial.BandThreads``, ``LocalSpatialAxis``):

- against the one-device engine at k = 2 and 4, for argmax labels, a
  bit-packed threshold and float probabilities: probabilities within
  atol 1e-5 (4.5e-07 measured at most), labels and packed masks equal on
  >= 99.9% of pixels, equal dtypes; each device's ``UNet.forward`` takes
  ``ph / k`` rows in a thread of its own;
- against the JAX engine's spatial mode over k JAX CPU devices, the same
  weights through ``state_dict_from_jax``: labels >= 99.9%,
  probabilities within atol 1e-4;
- the in-process axis's ``all_gather`` / ``all_reduce`` / ``halo`` /
  ``band_sum`` / ``gather_band`` / ``split_band`` against slices and sums
  of the whole tensor, the reduced sums bit-equal on every rank;
- a padded height that does not split over k warns once and equals one
  device bit for bit;
- three threads calling spatial mode on one engine each get their own
  call's mask;
- a band op that raises on device 1 raises from ``predict_image`` at
  once, leaves no thread behind, and the next call succeeds; a rank that
  hangs breaks the exchange after the timeout, and one that skips an
  exchange is named.
"""

import gc
import sys
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import patchgan_tpu_torch.models.blocks as blocks
from patchgan_tpu.inference import InferenceEngine as JaxEngine
from patchgan_tpu.models import UNet as JaxUNet
from patchgan_tpu.parallel.mesh import default_mesh as jax_default_mesh
from patchgan_tpu_torch.inference import InferenceEngine
from patchgan_tpu_torch.models import UNet
from patchgan_tpu_torch.parallel import default_mesh
from patchgan_tpu_torch.parallel.spatial import BandThreads
from patchgan_tpu_torch.utils.transfer import state_dict_from_jax

torch.set_num_threads(2)

SIZE, NF = 128, 8
PROB_ATOL = 1e-5        # against one device
JAX_ATOL = 1e-4         # against the JAX engine (test_torch_engine.py)
AGREE = 0.999
KINDS = {'argmax': (3, 'softmax', 0), 'packed-threshold': (1, 'sigmoid', 0.5),
         'float': (1, 'sigmoid', 0)}


def _images():
    """Padded heights 384, 128 and 256: each splits over 2 and 4."""
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, (300, 200, 3), dtype=np.uint8),
            rng.integers(0, 256, (100, 90, 3), dtype=np.uint8),
            rng.random((150, 260, 3), dtype=np.float32)]


def _engines(k, kind, seed=0):
    classes, final_act, threshold = KINDS[kind]
    model = UNet(3, classes, nf=NF, activation='relu', final_act=final_act,
                 generator=torch.Generator().manual_seed(seed))
    kw = dict(size=SIZE, threshold=threshold, dtype=torch.float32)
    return (InferenceEngine(model, device='cpu', **kw),
            InferenceEngine(model, mesh=default_mesh(['cpu'] * k), **kw))


def _check(got, want, kind, atol=PROB_ATOL):
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind == 'float':
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        assert np.mean(got == want) >= AGREE


@pytest.mark.parametrize('kind', list(KINDS))
@pytest.mark.parametrize('k', [2, 4])
def test_sharded_spatial_matches_one_device(k, kind):
    one, mesh = _engines(k, kind)
    with warnings.catch_warnings():
        warnings.simplefilter('error')      # every height splits: no warning
        for im in _images():
            got = mesh.predict_image(im, mode='spatial')
            want = one.predict_image(im, mode='spatial')
            assert got.shape == im.shape[:2]
            _check(got, want, kind)
            if kind == 'packed-threshold':
                assert set(np.unique(got)) <= {0.0, 1.0}


@pytest.mark.parametrize('k', [2, 4])
def test_each_device_takes_its_band(k, monkeypatch):
    """Every device's UNet.forward takes ph / k rows, on a spatial axis of
    k ranks, in a thread of its own; the whole-image forward is not
    called."""
    seen = []
    forward = UNet.forward

    def spy(self, x, *args, **kwargs):
        mesh = kwargs.get('mesh')
        seen.append((threading.current_thread().name, tuple(x.shape),
                     None if mesh is None else
                     (mesh.spatial.rank, mesh.spatial.size)))
        return forward(self, x, *args, **kwargs)

    monkeypatch.setattr(UNet, 'forward', spy)
    _, mesh = _engines(k, 'argmax')
    im = _images()[0]                       # padded 384 x 256
    mesh.predict_image(im, mode='spatial')
    assert sorted(s[2] for s in seen) == [(r, k) for r in range(k)]
    assert all(s[1] == (1, 3, 384 // k, 256) for s in seen)
    assert len({s[0] for s in seen}) == k


@pytest.mark.parametrize('kind', list(KINDS))
@pytest.mark.parametrize('k', [2, 4])
def test_sharded_spatial_matches_jax_mesh_engine(k, kind):
    """The JAX engine's spatial mode over k JAX CPU devices (the image's
    height sharded, P(None, 'data')) on the same weights."""
    classes, final_act, threshold = KINDS[kind]
    jmodel = JaxUNet(input_nc=3, output_nc=classes, nf=NF,
                     activation='relu', final_act=final_act)
    params = jax.device_get(jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((1, SIZE, SIZE, 3))))(jax.random.PRNGKey(4))['params'])
    jeng = JaxEngine(jmodel, params, size=SIZE, threshold=threshold,
                     mesh=jax_default_mesh(jax.devices()[:k]))
    peng = InferenceEngine(UNet(3, classes, nf=NF, activation='relu',
                                final_act=final_act),
                           state_dict_from_jax(params), size=SIZE,
                           threshold=threshold, dtype=torch.float32,
                           mesh=default_mesh(['cpu'] * k))
    with warnings.catch_warnings():
        warnings.simplefilter('error')      # neither engine falls back
        for im in _images()[:2]:
            got = peng.predict_image(im, mode='spatial')
            want = jeng.predict_image(im, mode='spatial')
            assert got.shape == im.shape[:2]
            _check(got, want, kind, atol=JAX_ATOL)


def _collectives(mesh):
    """Rank r's results of each collective on a seeded whole tensor."""
    axis = mesh.spatial
    r, k = axis.rank, axis.size
    g = torch.Generator().manual_seed(3)
    whole = torch.randn(2, 3, 8 * k, 5, generator=g)
    parts = torch.randn(k, 2, 3, 2, generator=g)
    band = axis.band(whole)
    reduced = parts[r].clone()
    axis.all_reduce(reduced, None)
    return {'gather': torch.cat(axis.all_gather(band, None), dim=2),
            'reduced': reduced,
            'band_sum': axis.band_sum(parts[r]),
            'stat': axis.stat(parts[r]),
            'halo11': axis.halo(band, 1, 1), 'halo12': axis.halo(band, 1, 2),
            'gather_band': axis.gather_band(band),
            'split_band': axis.split_band(whole),
            'whole': whole, 'parts': parts, 'rows': axis.rows(whole.shape[2])}


@pytest.mark.parametrize('k', [2, 3, 4])
def test_local_axis_collectives(k):
    out = BandThreads(k).run(['cpu'] * k, _collectives)
    want_sum = out[0]['parts'][0]
    for p in out[0]['parts'][1:]:
        want_sum = want_sum + p                 # rank order
    for r, res in enumerate(out):
        whole, (lo, hi) = res['whole'], res['rows']
        assert (lo, hi) == (r * 8, (r + 1) * 8)
        torch.testing.assert_close(res['gather'], whole, rtol=0, atol=0)
        torch.testing.assert_close(res['gather_band'], whole, rtol=0, atol=0)
        torch.testing.assert_close(res['split_band'], whole[:, :, lo:hi],
                                   rtol=0, atol=0)
        padded = torch.nn.functional.pad(whole, (0, 0, 1, 2))
        torch.testing.assert_close(res['halo11'], padded[:, :, lo:hi + 2],
                                   rtol=0, atol=0)
        torch.testing.assert_close(res['halo12'], padded[:, :, lo:hi + 3],
                                   rtol=0, atol=0)
        for key in ('reduced', 'band_sum', 'stat'):
            assert torch.equal(res[key], want_sum), key


def test_unsplit_height_warns_once_and_equals_one_device():
    """The 100 x 90 image pads to 128 rows, which do not split into 3
    bands of an even number of rows: the whole image runs on the home
    device, as JAX's engine does, with one warning an engine."""
    one, mesh = _engines(3, 'argmax')
    im = _images()[1]
    with pytest.warns(UserWarning, match='padded height 128 does not split'):
        got = mesh.predict_image(im, mode='spatial')
    np.testing.assert_array_equal(got, one.predict_image(im, mode='spatial'))
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        again = mesh.predict_image(im, mode='spatial')
    np.testing.assert_array_equal(again, got)


def test_concurrent_callers_get_their_own_masks():
    """Three caller threads on a 4-device engine (seven threads in all,
    the interpreter switching threads every microsecond): every call
    returns its own image's mask."""
    one, mesh = _engines(4, 'float')
    images = _images()
    want = [one.predict_image(im, mode='spatial') for im in images]
    got, errors = {}, []

    def caller(i):
        try:
            for n in range(3):
                j = (i + n) % len(images)
                got[(i, n)] = (j, mesh.predict_image(images[j],
                                                     mode='spatial'))
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(got) == 9
    for j, mask in got.values():
        assert mask.shape == want[j].shape
        np.testing.assert_allclose(mask, want[j], rtol=0, atol=PROB_ATOL)


def test_a_failing_device_raises_in_the_caller(monkeypatch):
    one, mesh = _engines(2, 'argmax')
    im = _images()[0]
    band_op = blocks.conv_norm_act_band

    def failing(xh, w, eps, activation, axis, *args, **kwargs):
        if axis.rank == 1:
            raise RuntimeError('band op failed on device 1')
        return band_op(xh, w, eps, activation, axis, *args, **kwargs)

    mesh.predict_image(im, mode='spatial')
    threads = set(threading.enumerate())
    monkeypatch.setattr(blocks, 'conv_norm_act_band', failing)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match='failed on device 1'):
        mesh.predict_image(im, mode='spatial')
    assert time.perf_counter() - t0 < 30
    # the engine's band threads are idle again, and no other is left
    assert mesh.band_threads().idle
    assert set(threading.enumerate()) == threads
    monkeypatch.setattr(blocks, 'conv_norm_act_band', band_op)
    np.testing.assert_array_equal(mesh.predict_image(im, mode='spatial'),
                                  one.predict_image(im, mode='spatial'))


@pytest.mark.parametrize('k', [2, 4])
def test_band_threads_outlive_a_call(k):
    """An engine's spatial forwards run on its BandThreads, rank r on
    thread r every call; a dropped engine's threads end."""
    _, mesh = _engines(k, 'float')
    im = _images()[1]
    before = set(threading.enumerate())
    mesh.predict_image(im, mode='spatial')
    pool = mesh.band_threads()
    mine = set(threading.enumerate()) - before
    assert sorted(t.name for t in mine) == [f'spatial-band-{r}'
                                            for r in range(k)]
    mesh.predict_image(im, mode='spatial')
    assert mesh.band_threads() is pool and pool.idle
    assert set(threading.enumerate()) - before == mine
    del mesh, pool
    gc.collect()
    for t in mine:
        t.join(10)
    assert not any(t.is_alive() for t in mine)


def test_a_rank_that_hangs_breaks_the_axis():
    """A rank that holds its turn longer than the timeout: the others'
    waits break, and the run says so once every rank has ended."""
    def fn(mesh):
        axis = mesh.spatial
        if axis.rank == 1:
            time.sleep(2)
        axis.all_reduce(torch.zeros(2), None)

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match='did not reach an exchange'):
        BandThreads(2).run(['cpu', 'cpu'], fn, timeout=0.5)
    assert time.perf_counter() - t0 < 30


def test_a_rank_that_skips_an_exchange_is_named():
    def fn(mesh):
        axis = mesh.spatial
        if axis.rank == 0:
            axis.all_reduce(torch.zeros(2), None)

    with pytest.raises(RuntimeError, match='rank 1 .* did not reach '
                                           'exchange 0'):
        BandThreads(2).run(['cpu', 'cpu'], fn, timeout=30)
