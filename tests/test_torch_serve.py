"""The port's ``patchgan_serve`` (``patchgan_tpu_torch/cli/serve.py``),
case for case against the JAX package's serve tests
(``tests/test_cli.py``): the watch loop (restart-safe, batched, warmup,
a corrupt file skipped), the stdin line protocol (input order, ERROR in
a failed line's place, batched and pipelined), the HTTP endpoint (PNG
masks, 400 for bad bytes, micro-batching, the SIGTERM drain of a ``-d
cpu`` subprocess) and the micro-batcher on its own; then both packages
serving one folder with the checkpoint a JAX ``patchgan_train`` wrote,
tiled and spatial, with masks that agree on >= 99.9% of pixels. Every
socket and subprocess wait has its own deadline."""

import io
import os
import queue
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from patchgan_tpu_torch.cli.serve import (_build_engine, _encode_mask_png,
                                          _http_loop, _MicroBatcher,
                                          _stdin_loop, patchgan_serve)
from patchgan_tpu_torch.models import UNet
from patchgan_tpu_torch.utils.checkpoint import save_state_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128
MODEL_PARAMS = {'generator': {'filters': 4, 'activation': 'relu',
                              'final_activation': 'softmax'}}


@pytest.fixture
def val_images(tmp_path):
    """Four 128 x 128 JPEGs with integer basenames."""
    d = tmp_path / 'val' / 'images'
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        img = (rng.uniform(size=(SIZE, SIZE, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(d / f'{i:012d}.jpg')
    return d


@pytest.fixture
def checkpoint(tmp_path):
    model = UNet(3, 2, nf=4, activation='relu', final_act='softmax',
                 generator=torch.Generator().manual_seed(3))
    path = tmp_path / 'generator_ep_001.npz'
    save_state_dict(str(path), model.state_dict())
    return str(path)


def serve_config(tmp_path, ckpt, out, name, **infer):
    cfg = {
        'dataset': {'type': 'COCOStuff', 'size': SIZE, 'labels': [1, 2]},
        'model_params': MODEL_PARAMS,
        'checkpoint_paths': {'generator': ckpt},
        'infer_params': {'output_path': str(tmp_path / out), **infer},
    }
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


CPU = ['-d', 'cpu', '--dtype', 'float32']


def _encoded(mask):
    """A mask as its served PNG decodes."""
    return np.asarray(Image.open(io.BytesIO(_encode_mask_png(mask))))


def test_serve_cli_watch_once_and_idempotent(tmp_path, val_images,
                                             checkpoint, capsys):
    """--watch --once serves the backlog and skips already-served images
    on the next pass (restart-safe)."""
    path = serve_config(tmp_path, checkpoint, 'served', 'serve.yaml',
                        threshold=0.5, overlap=0.9)
    n = patchgan_serve(['-c', path, '--once', '--no-warmup', '--watch',
                        str(val_images)] + CPU)
    assert n == 4
    masks = sorted(os.listdir(tmp_path / 'served'))
    assert len(masks) == 4
    arr = np.asarray(Image.open(tmp_path / 'served' / masks[0]))
    assert arr.shape == (SIZE, SIZE)
    capsys.readouterr()
    n = patchgan_serve(['-c', path, '--once', '--no-warmup', '--watch',
                        str(val_images)] + CPU)
    assert n == 0   # idempotent: everything already served


@pytest.mark.parametrize('mode', ['tiled', 'spatial'])
def test_serve_cli_batch_warmup_and_corrupt_file(tmp_path, val_images,
                                                 checkpoint, capsys, mode):
    """The warmup forward runs before the first image, --batch groups the
    backlog (tiled mode; spatial serves one image at a time), and a
    corrupt image is logged and skipped instead of stopping the service;
    the masks equal the unbatched engine's."""
    import shutil

    watch_dir = tmp_path / 'watch'
    watch_dir.mkdir()
    for f in sorted(os.listdir(val_images))[:3]:
        shutil.copy(val_images / f, watch_dir / f)
    (watch_dir / '00000000000a.jpg').write_bytes(b'not a jpeg')
    path = serve_config(tmp_path, checkpoint, 'served_b', 'serve_b.yaml',
                        threshold=0.5, overlap=0.9, mode=mode)
    n = patchgan_serve(['-c', path, '--once', '--watch', str(watch_dir),
                        '--batch', '4'] + CPU)
    out = capsys.readouterr().out
    assert 'warmup:' in out
    assert 'ERROR' in out and '00000000000a' in out
    assert n == 3   # the three good images, despite the corrupt one
    if mode == 'tiled':
        assert 'batch 3' in out   # grouped through one dispatch
    names = sorted(os.listdir(tmp_path / 'served_b'))
    assert len(names) == 3
    engine, _, _ = _build_engine(yaml.safe_load(open(path)), torch.float32,
                                 torch.device('cpu'))
    for name in names:
        image = np.asarray(Image.open(
            watch_dir / name.replace('.png', '.jpg')).convert('RGB'))
        want = engine.predict_image(image, mode=mode)
        got = np.asarray(Image.open(tmp_path / 'served_b' / name))
        np.testing.assert_array_equal(got, _encoded(want))


@pytest.mark.parametrize('device', ['cuda', 'auto'])
def test_serve_cli_without_gpu_raises(tmp_path, val_images, checkpoint,
                                      device, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    path = serve_config(tmp_path, checkpoint, 'x', 'x.yaml')
    with pytest.raises(RuntimeError, match='-d cpu'):
        patchgan_serve(['-c', path, '--once', '--watch', str(val_images),
                        '-d', device])


def _start_http(engine, **kwargs):
    ready = threading.Event()
    captured = {}

    def on_ready(server):
        captured['server'] = server
        ready.set()

    th = threading.Thread(target=_http_loop,
                          args=(engine, 'tiled', '127.0.0.1:0'),
                          kwargs={'server_ready': on_ready, **kwargs},
                          daemon=True)
    th.start()
    assert ready.wait(timeout=10)
    host, port = captured['server'].server_address
    return f'http://{host}:{port}', captured['server'], th


def _png(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, 'PNG')
    return buf.getvalue()


def _post(url, body, timeout):
    return urllib.request.urlopen(urllib.request.Request(
        url, data=body, method='POST'), timeout=timeout)


def test_serve_http_endpoint():
    """POST /predict answers the PNG mask in the save_mask encoding, GET
    /healthz answers ok, a bad body gets 400 and never takes the server
    down. A duck-typed engine: the HTTP layer only calls
    predict_image."""

    class DummyEngine:
        def predict_image(self, image, mode='tiled'):
            return image[..., 0]

    base, server, th = _start_http(DummyEngine())
    try:
        assert urllib.request.urlopen(f'{base}/healthz',
                                      timeout=10).read() == b'ok'
        rng = np.random.default_rng(0)
        img = (rng.uniform(size=(40, 50, 3)) * 255).astype(np.uint8)
        resp = _post(f'{base}/predict', _png(img), 30)
        assert resp.headers['Content-Type'] == 'image/png'
        mask = np.asarray(Image.open(io.BytesIO(resp.read())))
        assert mask.shape == (40, 50)
        np.testing.assert_array_equal(mask, img[..., 0])
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f'{base}/predict', b'not an image', 10)
        assert err.value.code == 400
        # still alive after the bad request
        assert urllib.request.urlopen(f'{base}/healthz',
                                      timeout=10).read() == b'ok'
    finally:
        server.shutdown()
        th.join(timeout=10)
    assert not th.is_alive()


def test_serve_http_failed_inference_answers_500():
    class FailingEngine:
        def predict_image(self, image, mode='tiled'):
            raise RuntimeError('device lost')

    base, server, th = _start_http(FailingEngine())
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f'{base}/predict', _png(np.zeros((8, 8, 3), np.uint8)),
                  10)
        assert err.value.code == 500
        assert urllib.request.urlopen(f'{base}/healthz',
                                      timeout=10).read() == b'ok'
    finally:
        server.shutdown()
        th.join(timeout=10)


def test_serve_http_sigterm_drains(tmp_path, checkpoint):
    """python -m patchgan_tpu_torch.cli.serve --http -d cpu exits 0 on
    SIGTERM after draining, and answers /healthz before it."""
    path = serve_config(tmp_path, checkpoint, 'served', 'serve_http.yaml')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'patchgan_tpu_torch.cli.serve', '-c', path,
         '--http', '127.0.0.1:0', '--no-warmup'] + CPU,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        # the readiness watch runs in a thread: a bare read loop would
        # block past any deadline if the server never came up
        lines = queue.Queue()

        def watch():
            for line in proc.stdout:
                lines.put(line)
            lines.put(None)

        threading.Thread(target=watch, daemon=True).start()
        base, out = None, []
        while base is None:
            line = lines.get(timeout=120)
            assert line is not None, ''.join(out)
            out.append(line)
            if 'HTTP serving on' in line:
                base = line.split()[3]
        assert urllib.request.urlopen(f'{base}/healthz',
                                      timeout=10).read() == b'ok'
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        while (line := lines.get(timeout=10)) is not None:
            out.append(line)
        assert 'draining in-flight requests' in ''.join(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


class Handle:
    def __init__(self, mask):
        self._mask = mask

    def result(self):
        return self._mask


def _stdin_lines(monkeypatch, lines):
    monkeypatch.setattr('sys.stdin', io.StringIO('\n'.join(lines) + '\n'))


def test_serve_stdin_loop_batched(val_images, tmp_path, monkeypatch,
                                  capsys):
    """--stdin --batch N: decoded lines dispatch as groups through
    predict_images_async, the echoes keep input order, and a bad path
    mid-stream is an ERROR at its own position."""
    group_sizes = []

    class DummyEngine:
        def predict_images_async(self, images):
            group_sizes.append(len(images))
            return [Handle(im[..., 0]) for im in images]

        def predict_image_async(self, image):
            group_sizes.append(1)
            return Handle(image[..., 0])

    imgs = sorted(str(p) for p in val_images.iterdir())[:4]
    lines = [imgs[0], imgs[1], str(tmp_path / 'missing.jpg'), imgs[2],
             imgs[3]]
    _stdin_lines(monkeypatch, lines)
    out_dir = tmp_path / 'stdin_batched'
    out_dir.mkdir()
    _stdin_loop(DummyEngine(), 'tiled', str(out_dir), workers=2, batch=3)
    out_lines = capsys.readouterr().out.strip().splitlines()
    assert len(out_lines) == 5
    stem = [os.path.splitext(os.path.basename(p))[0] for p in lines]
    for i in (0, 1, 3, 4):
        assert out_lines[i].endswith(f'{stem[i]}.png')
        assert os.path.exists(out_dir / f'{stem[i]}.png')
    assert out_lines[2].startswith('ERROR')
    # every line went through the engine; at least one group formed
    assert sum(group_sizes) == 4
    assert max(group_sizes) >= 2


def test_serve_stdin_loop_pipelined(val_images, tmp_path, monkeypatch,
                                    capsys):
    """--stdin: one echoed mask path (or "ERROR <msg>") per line, in
    input order, with one dispatched image in flight; the trailing handle
    is resolved before the loop returns."""

    class DummyEngine:
        def predict_image_async(self, image):
            return Handle(image[..., 0])

    imgs = sorted(str(p) for p in val_images.iterdir())[:3]
    lines = [imgs[0], str(tmp_path / 'missing.jpg'), imgs[1], imgs[2]]
    _stdin_lines(monkeypatch, lines)
    out_dir = tmp_path / 'stdin_served'
    out_dir.mkdir()
    _stdin_loop(DummyEngine(), 'tiled', str(out_dir), workers=2)
    out_lines = capsys.readouterr().out.strip().splitlines()
    assert len(out_lines) == 4
    stem = [os.path.splitext(os.path.basename(p))[0] for p in lines]
    assert out_lines[0].endswith(f'{stem[0]}.png')
    assert out_lines[1].startswith('ERROR')
    assert out_lines[2].endswith(f'{stem[2]}.png')
    assert out_lines[3].endswith(f'{stem[3]}.png')
    for k in (0, 2, 3):
        assert os.path.exists(out_dir / f'{stem[k]}.png')


@pytest.mark.parametrize('mode', ['tiled', 'spatial'])
def test_serve_stdin_cli_real_engine(tmp_path, val_images, checkpoint,
                                     monkeypatch, capsys, mode):
    """patchgan_serve --stdin --batch 2 on the CPU with the real engine:
    masks in input order, each equal to the engine's own mask."""
    path = serve_config(tmp_path, checkpoint, 'stdin_out', 's.yaml',
                        mode=mode)
    imgs = sorted(str(p) for p in val_images.iterdir())
    lines = [imgs[0], str(tmp_path / 'missing.png'), imgs[1], imgs[2]]
    _stdin_lines(monkeypatch, lines)
    patchgan_serve(['-c', path, '--stdin', '--batch', '2',
                    '--no-warmup'] + CPU)
    out = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith(('ERROR', str(tmp_path)))]
    assert len(out) == 4 and out[1].startswith('ERROR')
    engine, _, _ = _build_engine(yaml.safe_load(open(path)), torch.float32,
                                 torch.device('cpu'))
    for line, src in zip(out[:1] + out[2:], imgs[:3]):
        got = np.asarray(Image.open(line))
        want = engine.predict_image(np.asarray(Image.open(src)), mode=mode)
        np.testing.assert_array_equal(got, _encoded(want))


def test_micro_batcher_groups_and_isolates_failures():
    """Concurrent submissions within the wait window go through one
    predict_images call, each caller gets its own mask, a failing group
    raises in every member, and the dispatcher survives."""
    calls = []

    class Engine:
        def predict_images(self, images):
            calls.append(len(images))
            if any(im.shape[0] == 13 for im in images):
                raise RuntimeError('poison image')
            return [im[..., 0] * 2.0 for im in images]

        def predict_image(self, image, mode='tiled'):
            calls.append(1)
            if image.shape[0] == 13:
                raise RuntimeError('poison image')
            return image[..., 0] * 2.0

    batcher = _MicroBatcher(Engine(), 'tiled', max_batch=8, max_wait=2.0)
    try:
        imgs = [np.full((4, 4, 3), i, np.float32) for i in range(3)]
        results = [None] * 3

        def post(i):
            results[i] = batcher.predict(imgs[i])

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert calls == [3]
        for i in range(3):
            np.testing.assert_allclose(results[i], imgs[i][..., 0] * 2.0)
        errs = []

        def post_bad():
            try:
                batcher.predict(np.zeros((13, 4, 3), np.float32))
            except RuntimeError as e:
                errs.append(e)

        t = threading.Thread(target=post_bad)
        t.start()
        t.join(timeout=30)
        assert len(errs) == 1
        out = batcher.predict(imgs[0])
        np.testing.assert_allclose(out, imgs[0][..., 0] * 2.0)
    finally:
        batcher.close()


def test_micro_batcher_prefers_async_handles():
    """With predict_images_async the batcher hands each request its
    handle and the request thread resolves it; a handle whose result()
    raises fails only its own request."""

    class FnHandle:
        def __init__(self, fn):
            self._fn = fn

        def result(self):
            return self._fn()

    class Engine:
        def predict_images_async(self, images):
            def make(im):
                if im.shape[0] == 13:
                    return FnHandle(lambda: (_ for _ in ()).throw(
                        RuntimeError('bad fetch')))
                return FnHandle(lambda: im[..., 0] + 1.0)
            return [make(im) for im in images]

    batcher = _MicroBatcher(Engine(), 'tiled', max_batch=4, max_wait=2.0)
    try:
        good = np.zeros((4, 4, 3), np.float32)
        bad = np.zeros((13, 4, 3), np.float32)
        results, errs = {}, {}

        def post(key, img):
            try:
                results[key] = batcher.predict(img)
            except RuntimeError as e:
                errs[key] = e

        threads = [threading.Thread(target=post, args=kv)
                   for kv in [('a', good), ('b', bad), ('c', good)]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert set(results) == {'a', 'c'} and set(errs) == {'b'}
        np.testing.assert_allclose(results['a'], good[..., 0] + 1.0)
    finally:
        batcher.close()


def test_micro_batcher_close_rejects_and_drains():
    """After close(): new predict() calls raise at once, and items queued
    behind the close sentinel are failed, not left blocking."""

    class StallEngine:
        def __init__(self):
            self.go = threading.Event()

        def predict_images_async(self, images):
            self.go.wait(timeout=30)   # the dispatcher stalls in a group
            return [Handle(im[..., 0]) for im in images]

    eng = StallEngine()
    batcher = _MicroBatcher(eng, 'tiled', max_batch=1, max_wait=0.0)
    img = np.zeros((4, 4, 3), np.float32)
    results = []
    t = threading.Thread(
        target=lambda: results.append(batcher.predict(img)))
    t.start()
    for _ in range(100):
        if batcher._q.empty() and t.is_alive():
            break
        threading.Event().wait(0.01)
    batcher._closed = True
    batcher._q.put(batcher._CLOSE)
    orphan = {'image': img, 'done': threading.Event()}
    batcher._q.put(orphan)
    eng.go.set()
    t.join(timeout=10)
    batcher._thread.join(timeout=10)
    assert not t.is_alive() and not batcher._thread.is_alive()
    np.testing.assert_allclose(results[0], img[..., 0])
    assert orphan['done'].wait(timeout=10)
    assert isinstance(orphan.get('error'), RuntimeError)
    with pytest.raises(RuntimeError, match='closed'):
        batcher.predict(img)


def test_serve_http_micro_batching():
    """--http --batch N: concurrent POSTs are micro-batched and each
    response carries its own request's mask."""
    grouped = []

    class Engine:
        def predict_images(self, images):
            grouped.append(len(images))
            return [im[..., 0] for im in images]

        def predict_image(self, image, mode='tiled'):
            grouped.append(1)
            return image[..., 0]

    base, server, th = _start_http(Engine(), batch=4, batch_wait=2.0)
    try:
        rng = np.random.default_rng(3)
        imgs = [(rng.uniform(size=(24, 30, 3)) * 255).astype(np.uint8)
                for _ in range(3)]
        masks = [None] * 3

        def post(i):
            resp = _post(f'{base}/predict', _png(imgs[i]), 60)
            masks[i] = np.asarray(Image.open(io.BytesIO(resp.read())))

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for i in range(3):
            np.testing.assert_array_equal(masks[i], imgs[i][..., 0])
        assert sum(grouped) == 3
        assert max(grouped) >= 2
    finally:
        server.shutdown()
        th.join(timeout=10)


# ------------------------------------------------------ against JAX serve

@pytest.fixture(scope='module')
def jax_checkpoint(tmp_path_factory):
    """generator_ep_001.npz of one epoch of the JAX package's
    patchgan_train (nf=4, 128 px, fp32) on a seeded COCO-style tree."""
    from patchgan_tpu.cli.train import patchgan_train as jax_train
    root = tmp_path_factory.mktemp('jax_train')
    rng = np.random.default_rng(0)
    for split, n in (('train', 4), ('val', 2)):
        for sub in ('images', 'masks'):
            (root / split / sub).mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.uniform(size=(SIZE, SIZE, 3)) * 255)
                            .astype(np.uint8)).save(
                root / split / 'images' / f'{i:012d}.jpg')
            Image.fromarray(rng.integers(0, 2, (SIZE, SIZE))
                            .astype(np.uint8), mode='L').save(
                root / split / 'masks' / f'{i:012d}.png')
    cfg = {
        'dataset': {'type': 'COCOStuff', 'size': SIZE, 'labels': [1, 2],
                    'train_data': {'images': str(root / 'train/images'),
                                   'masks': str(root / 'train/masks')},
                    'validation_data': {'images': str(root / 'val/images'),
                                        'masks': str(root / 'val/masks')}},
        'model_params': {**MODEL_PARAMS,
                         'discriminator': {'filters': 4, 'n_layers': 2}},
        'checkpoint_path': str(root / 'ck'),
        'train_params': {'loss_type': 'tversky', 'seg_alpha': 200,
                         'gen_learning_rate': 1e-3,
                         'disc_learning_rate': 1e-3, 'save_freq': 1},
    }
    path = root / 'train.yaml'
    path.write_text(yaml.safe_dump(cfg))
    jax_train(['-c', str(path), '-n', '1', '-b', '4', '--dtype', 'float32',
               '--no-summary'])
    return str(root / 'ck' / 'generator_ep_001.npz')


@pytest.mark.parametrize('mode', ['tiled', 'spatial'])
def test_serve_watch_matches_jax(tmp_path, jax_checkpoint, mode):
    """Both packages' --watch --once on one PNG folder (a 128 x 128, a
    200 x 150 and a 300 x 170 image) with the JAX-trained checkpoint, fp32:
    the same PNG names, shapes and dtypes, masks equal on >= 99.9% of the
    pixels."""
    from patchgan_tpu.cli.serve import patchgan_serve as jax_serve
    watch = tmp_path / 'png'
    watch.mkdir()
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate([(SIZE, SIZE), (200, 150), (300, 170)]):
        Image.fromarray((rng.uniform(size=(h, w, 3)) * 255)
                        .astype(np.uint8)).save(watch / f'{i:03d}.png')
    for pkg, serve, extra in (('port', patchgan_serve, CPU),
                              ('jax', jax_serve, ['--dtype', 'float32'])):
        path = serve_config(tmp_path, jax_checkpoint, pkg, f'{pkg}.yaml',
                            mode=mode, overlap=0.9)
        assert serve(['-c', path, '--once', '--no-warmup', '--watch',
                      str(watch)] + extra) == 3
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert names == sorted(os.listdir(tmp_path / 'port')) and \
        len(names) == 3
    for name, (h, w) in zip(names, [(SIZE, SIZE), (200, 150), (300, 170)]):
        got = np.asarray(Image.open(tmp_path / 'port' / name))
        want = np.asarray(Image.open(tmp_path / 'jax' / name))
        assert got.shape == want.shape == (h, w)
        assert got.dtype == want.dtype
        assert set(np.unique(want)) == {0, 1}   # not a constant mask
        assert np.mean(got == want) >= 0.999
