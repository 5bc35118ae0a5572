"""Long-running inference service: ``python -m patchgan_tpu_torch.cli.serve``.

Port of ``patchgan_tpu/cli/serve.py``: the same flags and config keys.
The generator is loaded once and a warmup forward runs at startup (on
the card it builds the kernels with nvcc at first use), so the first
request pays no build. Decode runs in look-ahead threads that overlap
the device; the watch and stdin loops keep one dispatched image in
flight, so the mask copy and PNG save of image i-1 overlap image i's
device pipeline (``engine.predict_image_async``); a corrupt input is
logged and skipped (remembered by mtime: one bad file never stops the
service); ``--batch N`` groups images through
``engine.predict_images_async`` in all three modes. Images come from

- a watched directory (``--watch DIR``): new images are picked up each
  poll and their masks written to ``infer_params.output_path``; an image
  whose PNG exists is skipped, so the service is restart-safe and
  idempotent;
- a line protocol on stdin (``--stdin``): one input path per line, the
  written mask path echoed per line in input order ("ERROR <msg>" in a
  failed line's place);
- an HTTP endpoint (``--http HOST:PORT``): ``POST /predict`` with the
  image bytes (JPEG or PNG) answers the PNG mask (the ``save_mask``
  encoding), 400 for bad image bytes and 500 for a failed inference;
  ``GET /healthz`` answers 200 once the warmup forward is done. With
  ``--batch N`` concurrent requests are micro-batched: a dispatcher
  thread gathers requests arriving within ``--batch-wait-ms`` of each
  other and dispatches them as one group (``_MicroBatcher``). SIGTERM
  stops accepting, finishes the requests in flight, and exits 0.

Config: the infer CLI's schema (flat or nested ``model_params``,
``checkpoint_paths.generator``), with ``dataset.size`` and
``infer_params`` (``output_path``, ``threshold``, ``overlap``,
``batch_size``, ``mode: tiled|spatial``). ``-d auto`` (the default) and
``-d cuda`` run one engine over every visible card
(``CUDA_VISIBLE_DEVICES``), as the JAX server's ``default_mesh()`` does,
and raise without one; ``-d cuda:N`` runs on that card alone and ``-d
cpu`` on the CPU. It runs as one process: under torchrun with more than
one rank it raises.
"""

import argparse
import os
import sys
import time

IMAGE_EXTS = ('.jpg', '.jpeg', '.png')


def _build_engine(config, dtype, device, mesh=None):
    """The engine, the mode and the output folder of ``config``, on
    ``device`` or over ``mesh`` (``common.engine_devices``)."""
    import torch

    from ..inference import InferenceEngine
    from ..models import UNet
    from ..utils import checkpoint as ckpt
    from ..utils.config import model_params
    from ..utils.transfer import load_transfer_data, unet_key_map

    dataset_params = config.get('dataset', {})
    size = dataset_params.get('size', 256)
    in_channels = dataset_params.get('in_channels', 3)
    labels = dataset_params.get('labels')
    out_channels = len(labels) if labels else \
        dataset_params.get('out_channels', 1)

    gen_cfg, _ = model_params(config)
    generator = UNet(input_nc=in_channels, output_nc=out_channels,
                     nf=gen_cfg['filters'],
                     activation=gen_cfg['activation'],
                     final_act=gen_cfg['final_activation'], dtype=dtype,
                     generator=torch.Generator().manual_seed(0))
    gen_sd = ckpt.load_state_dict(config['checkpoint_paths']['generator'])
    count = load_transfer_data(generator, gen_sd, verbose=False)
    if count < len(unet_key_map()):
        raise ValueError(
            f"Generator checkpoint mismatch: {count}/"
            f"{len(unet_key_map())} weights loaded")

    infer_params = config.get('infer_params', {})
    engine = InferenceEngine(
        generator, size=size,
        overlap=infer_params.get('overlap', 0.9),
        threshold=infer_params.get('threshold', 0),
        batch_size=infer_params.get('batch_size', 128), device=device,
        mesh=mesh)
    mode = infer_params.get('mode', 'tiled')
    output_path = infer_params.get('output_path', 'predictions/')
    os.makedirs(output_path, exist_ok=True)
    return engine, mode, output_path


def _decode(path):
    """HWC uint8 RGB (the engine divides by 255 on the device): a JPEG
    through the native decode (``data/native.py``), anything else through
    PIL, as the JAX server decodes (``cli/serve.py:104-109``)."""
    import numpy as np

    from ..data import native
    if path.lower().endswith(('.jpg', '.jpeg')):
        return native.decode_jpeg_rgb_u8(path, None)
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'), np.uint8)


def _save(mask, output_path, path):
    from ..data.coco import COCOStuffDataset
    fname = os.path.splitext(os.path.basename(path))[0]
    COCOStuffDataset.save_mask(mask, output_path, fname)
    return os.path.join(output_path, f'{fname}.png')


def _dispatch_one(engine, mode, path, image=None):
    """Dispatch one image's forward; returns a handle whose ``.result()``
    is the mask. In tiled mode the engine's async path queues the whole
    pipeline on the device and returns before the mask's copy, so the
    serve loops overlap image i's device work with the copy and PNG save
    of image i-1."""
    if image is None:
        image = _decode(path)
    if mode == 'tiled' and hasattr(engine, 'predict_image_async'):
        return engine.predict_image_async(image)
    from ..inference.engine import _ReadyMask
    return _ReadyMask(engine.predict_image(image, mode=mode))


def _warmup(engine, mode, all_buckets=False):
    """Run a forward of ``size``-px uint8 zeros in ``mode`` before the
    first request: on the card it builds the kernels and sizes the
    memory pools, so request 1 pays neither. ``all_buckets`` (HTTP
    micro-batching, where grouped requests bring varied tile counts) also
    runs one tiled forward at every bucket of the table up to the
    engine's cap."""
    import numpy as np
    import torch

    from ..inference.engine import _BUCKET_REL_RATE
    t0 = time.perf_counter()
    c, size = engine.model.input_nc, engine.size
    engine.predict_image(np.zeros((size, size, c), np.uint8), mode=mode)
    if all_buckets and mode != 'spatial':
        with torch.inference_mode():
            for b in sorted(b for b in _BUCKET_REL_RATE
                            if b <= engine.batch_size
                            and b % engine.n_devices == 0):
                engine._forward_bucket(torch.zeros((b, c, size, size),
                                                   device=engine.device))
        if engine.device.type == 'cuda':
            # every card's share is copied back to home's stream
            torch.cuda.synchronize(engine.device)
    print(f"warmup: {mode} forward done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _decode_ahead(pool, paths, lookahead=4):
    """Yield (path, image_or_exception) with a bounded decode window
    running ahead of the consumer (the infer CLI's look-ahead)."""
    from collections import deque

    pending = deque()
    it = iter(paths)
    try:
        while len(pending) < lookahead:
            p = next(it)
            pending.append((p, pool.submit(_decode, p)))
    except StopIteration:
        it = iter(())
    while pending:
        path, fut = pending.popleft()
        for p in it:
            pending.append((p, pool.submit(_decode, p)))
            break
        try:
            yield path, fut.result()
        except Exception as e:
            yield path, e


def _watch_loop(engine, mode, output_path, watch_dir, poll, once,
                batch=0, workers=2):
    """Poll ``watch_dir``; decode ahead of the device; serve each new
    image (or, with ``batch`` > 1, groups of images). A file that fails
    (corrupt or truncated image) is logged, remembered by mtime, and
    skipped until it changes."""
    from concurrent.futures import ThreadPoolExecutor

    served = 0
    failed = {}  # path -> mtime at failure; retried if rewritten
    prev = None  # in-flight (path, mask handle, dispatch t0)

    def fail(path, e):
        try:
            failed[path] = os.path.getmtime(path)
        except OSError:
            pass
        print(f"ERROR {path}: {e}", flush=True)

    def resolve_prev():
        nonlocal served, prev
        if prev is None:
            return
        path, handle, t0 = prev
        prev = None
        try:
            out = _save(handle.result(), output_path, path)
            served += 1
            print(f"{out}  "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms)",
                  flush=True)
        except Exception as e:
            fail(path, e)

    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        while True:
            todo = []
            for name in sorted(os.listdir(watch_dir)):
                if not name.lower().endswith(IMAGE_EXTS):
                    continue
                out = os.path.join(
                    output_path, os.path.splitext(name)[0] + '.png')
                path = os.path.join(watch_dir, name)
                if os.path.exists(out):
                    continue
                try:
                    mtime = os.path.getmtime(path)
                except OSError:
                    continue  # raced with deletion
                if failed.get(path) == mtime:
                    continue
                todo.append(path)

            group, group_imgs = [], []

            def flush_group():
                # one failing image (copy or PNG save) fails only itself:
                # the group is consumed up front and every member
                # resolves inside its own try; flush_group never raises
                from ..inference.engine import _ReadyMask
                nonlocal served
                if not group:
                    return
                paths, imgs = list(group), list(group_imgs)
                group.clear()
                group_imgs.clear()
                t0 = time.perf_counter()
                try:
                    # dispatch the whole group before waiting on any mask
                    if hasattr(engine, 'predict_images_async'):
                        handles = engine.predict_images_async(imgs)
                    else:
                        handles = [_ReadyMask(m) for m in
                                   engine.predict_images(imgs)]
                except Exception as e:
                    for p in paths:
                        fail(p, e)
                    return
                results = []
                for p, h in zip(paths, handles):
                    try:
                        results.append((p, _save(h.result(),
                                                 output_path, p)))
                        served += 1
                    except Exception as e:
                        fail(p, e)
                dt = (time.perf_counter() - t0) * 1e3 / len(paths)
                for p, out in results:
                    print(f"{out}  ({dt:.0f} ms/img, "
                          f"batch {len(paths)})", flush=True)

            for path, image in _decode_ahead(pool, todo):
                try:
                    if isinstance(image, Exception):
                        raise image
                    if batch > 1 and mode != 'spatial':
                        group.append(path)
                        group_imgs.append(image)
                        if len(group) >= batch:
                            flush_group()
                        continue
                    t0 = time.perf_counter()
                    handle = _dispatch_one(engine, mode, path,
                                           image=image)
                except Exception as e:
                    resolve_prev()
                    fail(path, e)
                    continue
                # image i is now dispatched: copy back and save image i-1
                # while the device runs (one handle in flight keeps
                # memory flat and results in input order)
                resolve_prev()
                prev = (path, handle, t0)
            resolve_prev()
            flush_group()
            if once:
                print(f"served {served} images", flush=True)
                return served
            time.sleep(poll)


def _stdin_loop(engine, mode, output_path, workers=2, batch=0):
    """One input path per line; the mask path (or "ERROR <msg>") echoed
    per line, in input order. A feeder thread reads stdin into a queue
    and the decode pool works on queued paths while the current forward
    runs. With ``batch`` > 1 up to that many decoded lines dispatch as
    one group (``engine.predict_images_async``) while the previous
    group's masks are copied back and saved; a group forms only from
    lines already decoded, never by waiting, so an interactive single
    line is answered at once."""
    import queue
    import threading
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    paths_q = queue.Queue(maxsize=64)
    DONE = object()

    def feeder():
        for line in sys.stdin:
            paths_q.put(line.strip())
        paths_q.put(DONE)

    threading.Thread(target=feeder, daemon=True).start()

    done = False
    pending = deque()
    group_max = max(1, batch) if mode != 'spatial' else 1
    prev = None  # dispatched group: ordered ('err', exc) |
    #              ('ok', (path, handle)) entries

    def resolve_prev():
        nonlocal prev
        if prev is None:
            return
        entries, prev = prev, None
        for kind, payload in entries:
            if kind == 'err':
                print(f"ERROR {payload}", flush=True)
                continue
            path, handle = payload
            try:
                print(_save(handle.result(), output_path, path),
                      flush=True)
            except Exception as e:
                print(f"ERROR {e}", flush=True)

    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        while True:
            # top up the decode window; block only when nothing at all
            # is in flight
            window = max(2 * max(1, workers), group_max)
            while not done and len(pending) < window:
                try:
                    p = paths_q.get(block=not pending and prev is None)
                except queue.Empty:
                    break
                if p is DONE:
                    done = True
                elif p:
                    pending.append((p, pool.submit(_decode, p)))
            if not pending:
                # no further input queued: echo the in-flight results
                # now rather than hold them until the next line arrives
                resolve_prev()
                if done:
                    return
                continue
            # consume up to group_max decoded lines, keeping each line's
            # slot (a decode failure stays an ERROR at its position)
            entries = []
            while pending and len(entries) < group_max:
                path, fut = pending.popleft()
                try:
                    entries.append(('ok', (path, fut.result())))
                except Exception as e:
                    entries.append(('err', e))
            ok = [pay for kind, pay in entries if kind == 'ok']
            try:
                if len(ok) > 1 and \
                        hasattr(engine, 'predict_images_async'):
                    handles = engine.predict_images_async(
                        [im for _, im in ok])
                else:
                    handles = [_dispatch_one(engine, mode, p, image=im)
                               for p, im in ok]
            except Exception as e:  # dispatch failed: fail this group
                resolve_prev()
                for kind, pay in entries:
                    print(f"ERROR {pay if kind == 'err' else e}",
                          flush=True)
                continue
            handle_it = iter(handles)
            dispatched = [
                (kind, pay if kind == 'err'
                 else (pay[0], next(handle_it)))
                for kind, pay in entries]
            # copy and save of group i-1 overlap group i's device work
            resolve_prev()
            prev = dispatched


def _encode_mask_png(mask):
    """PNG-encode a mask with COCOStuffDataset.save_mask's uint8 scaling,
    to bytes."""
    import io

    import numpy as np
    from PIL import Image

    arr = np.asarray(mask)
    if arr.dtype in (np.float32, np.float64):
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8) \
            if arr.max() <= 1.0 else arr.astype(np.uint8)
    else:
        arr = arr.astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, 'PNG')
    return buf.getvalue()


class _MicroBatcher:
    """Cross-request batching for the HTTP front end.

    Request threads call :meth:`predict` and block; one dispatcher thread
    drains the queue, gathers up to ``max_batch`` images that arrive
    within ``max_wait`` seconds of the first, and dispatches the group
    through the engine (``predict_images_async`` when it has one). The
    per-image handles go back to the request threads, which wait for
    their own mask's copy and PNG-encode concurrently while the
    dispatcher forms the next group. While a group runs, new arrivals
    queue up and form the next one, so the batch grows with load and the
    wait window costs latency only when the service is idle. A failed
    group fails only its own requests; the dispatcher thread never
    dies."""

    _CLOSE = object()

    def __init__(self, engine, mode, max_batch, max_wait):
        import queue
        import threading

        self._engine = engine
        self._mode = mode
        self._max_batch = max(1, int(max_batch))
        self._max_wait = max(0.0, float(max_wait))
        self._q = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def predict(self, image):
        """Blocking: returns the mask (or raises)."""
        import threading

        if self._closed:
            raise RuntimeError('batcher is closed')
        item = {'image': image, 'done': threading.Event()}
        self._q.put(item)
        item['done'].wait()
        if 'error' in item:
            raise item['error']
        if 'handle' in item:
            # resolved here, in the request thread: a group's copies are
            # waited for concurrently, not one after another
            return item['handle'].result()
        return item['mask']

    def close(self):
        # the flag turns away new predict() calls; items that slipped
        # past the check before the sentinel are failed by _run's final
        # drain, so no caller is left blocking on a dead thread
        # (_http_loop closes the batcher only after server_close() has
        # joined the request handlers)
        self._closed = True
        self._q.put(self._CLOSE)
        self._thread.join(timeout=10)

    def _drain_and_fail(self):
        import queue

        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                return
            if it is self._CLOSE:
                continue
            it['error'] = RuntimeError('batcher is closed')
            it['done'].set()

    def _run(self):
        import queue

        while True:
            first = self._q.get()
            if first is self._CLOSE:
                self._drain_and_fail()
                return
            group = [first]
            deadline = time.monotonic() + self._max_wait
            closing = False
            while len(group) < self._max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is self._CLOSE:
                    closing = True
                    break
                group.append(nxt)
            try:
                if self._mode != 'spatial' and \
                        hasattr(self._engine, 'predict_images_async'):
                    handles = self._engine.predict_images_async(
                        [it['image'] for it in group])
                    for it, h in zip(group, handles):
                        it['handle'] = h
                elif len(group) > 1 and self._mode != 'spatial' and \
                        hasattr(self._engine, 'predict_images'):
                    masks = self._engine.predict_images(
                        [it['image'] for it in group])
                    for it, m in zip(group, masks):
                        it['mask'] = m
                else:
                    for it in group:
                        it['mask'] = self._engine.predict_image(
                            it['image'], mode=self._mode)
            except Exception as e:  # fail the group, keep serving
                for it in group:
                    it['error'] = e
            finally:
                for it in group:
                    it['done'].set()
            if closing:
                self._drain_and_fail()
                return


def _http_loop(engine, mode, addr, server_ready=None, batch=0,
               batch_wait=0.01):
    """Blocking HTTP front end: POST /predict (image bytes in, PNG mask
    bytes out), GET /healthz. Decode and PNG encode run in each request's
    thread. Without batching a lock serialises only the dispatch
    (``_dispatch_one``): the wait for request i's mask and its PNG
    encode run outside it, overlapping request i+1's device work. With
    ``batch`` > 1 concurrent requests are micro-batched
    (:class:`_MicroBatcher`). An undecodable body answers 400 and a
    failed inference 500; neither stops the service."""
    import io
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np
    from PIL import Image

    forward_lock = threading.Lock()
    batcher = (_MicroBatcher(engine, mode, batch, batch_wait)
               if batch > 1 and mode != 'spatial' else None)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *_):
            pass  # one line per request below instead of stderr noise

        def _reply(self, code, body, ctype='text/plain'):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/healthz':
                self._reply(200, b'ok')
            else:
                self._reply(404, b'not found')

        def do_POST(self):
            if self.path != '/predict':
                self._reply(404, b'not found')
                return
            try:
                n = int(self.headers.get('Content-Length', 0))
                # uint8 to the device, which divides by 255
                image = np.asarray(
                    Image.open(io.BytesIO(self.rfile.read(n)))
                    .convert('RGB'), np.uint8)
            except Exception as e:
                self._reply(400, f'bad image: {e}'.encode())
                return
            try:
                t0 = time.perf_counter()
                if batcher is not None:
                    mask = batcher.predict(image)
                else:
                    # the lock covers only the dispatch: this request's
                    # wait for its mask and its PNG encode overlap the
                    # next request's device work
                    with forward_lock:
                        handle = _dispatch_one(engine, mode, None,
                                               image=image)
                    mask = handle.result()
                png = _encode_mask_png(mask)
                self._reply(200, png, ctype='image/png')
                print(f"POST /predict {image.shape[1]}x{image.shape[0]}"
                      f" -> {len(png)} B "
                      f"({(time.perf_counter() - t0) * 1e3:.0f} ms)",
                      flush=True)
            except Exception as e:  # never take the service down
                self._reply(500, f'inference failed: {e}'.encode())
                print(f"ERROR /predict: {e}", flush=True)

    host, _, port = addr.rpartition(':')
    server = ThreadingHTTPServer((host or '127.0.0.1', int(port)),
                                 Handler)
    # non-daemon handler threads: with ThreadingHTTPServer's default
    # daemon_threads=True, server_close() would not join the requests in
    # flight and the process exit would kill them mid-request, which the
    # SIGTERM drain exists to avoid
    server.daemon_threads = False
    if threading.current_thread() is threading.main_thread():
        # drain on SIGTERM (an orchestrator's stop signal): stop
        # accepting, finish the requests in flight, exit 0. Installed
        # before the readiness line, since whatever reacts to it may
        # signal at once.
        import signal

        def _drain(signum, frame):
            print('SIGTERM: draining in-flight requests', flush=True)
            threading.Thread(target=server.shutdown,
                             daemon=True).start()

        signal.signal(signal.SIGTERM, _drain)
    print(f"HTTP serving on http://{server.server_address[0]}:"
          f"{server.server_address[1]} (POST /predict, GET /healthz)",
          flush=True)
    if server_ready is not None:
        server_ready(server)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()


def patchgan_serve(argv=None):
    parser = argparse.ArgumentParser(
        prog='PatchGAN',
        description='Long-running PatchGAN inference service')
    parser.add_argument('-c', '--config_file', required=True, type=str)
    parser.add_argument('--watch', default=None,
                        help='Directory to watch for new images')
    parser.add_argument('--stdin', action='store_true',
                        help='Serve paths read line-by-line from stdin')
    parser.add_argument('--http', default=None, metavar='HOST:PORT',
                        help='Serve an HTTP endpoint: POST /predict '
                             '(image bytes -> PNG mask), GET /healthz')
    parser.add_argument('--poll', default=2.0, type=float,
                        help='Watch-mode poll interval (seconds)')
    parser.add_argument('--once', action='store_true',
                        help='Watch mode: process the backlog and exit')
    parser.add_argument('--batch', default=0, type=int,
                        help='Group up to N images through one device '
                             'dispatch (tiled mode): watch-mode '
                             'backlog, stdin piped lines, or '
                             'concurrent HTTP requests (micro-batch)')
    parser.add_argument('--batch-wait-ms', default=10.0, type=float,
                        help='HTTP micro-batching: how long the first '
                             'request of a group waits for company '
                             'before dispatching (costs latency only '
                             'when the service is idle)')
    parser.add_argument('--workers', default=2, type=int,
                        help='Decode look-ahead threads')
    parser.add_argument('--no-warmup', action='store_true',
                        help='Skip the warmup forward at startup')
    parser.add_argument('-d', '--device', default='auto',
                        help="Device to use: 'auto' or 'cuda' (every "
                             "visible card), 'cuda:N' or 'cpu'")
    parser.add_argument('--dtype', default='auto',
                        choices=['auto', 'float32', 'bfloat16'])
    args = parser.parse_args(argv)

    if sum(map(bool, (args.watch, args.stdin, args.http))) != 1:
        parser.error(
            'exactly one of --watch / --stdin / --http is required')

    from ..utils.config import load_config
    from .common import compute_dtype, engine_devices, refuse_ranks

    refuse_ranks('patchgan_serve')
    device, mesh = engine_devices(args.device)
    dtype = compute_dtype(args.dtype, device)
    config = load_config(args.config_file)
    engine, mode, output_path = _build_engine(config, dtype, device, mesh)
    if not args.no_warmup:
        _warmup(engine, mode,
                all_buckets=bool(args.http) and args.batch > 1)
    where = mesh.describe() if mesh is not None else device
    print(f"Serving on {where} ({mode} mode) -> {output_path}", flush=True)

    if args.http:
        _http_loop(engine, mode, args.http, batch=args.batch,
                   batch_wait=args.batch_wait_ms / 1e3)
    elif args.stdin:
        _stdin_loop(engine, mode, output_path, workers=args.workers,
                    batch=args.batch)
    else:
        return _watch_loop(engine, mode, output_path, args.watch,
                           args.poll, args.once, batch=args.batch,
                           workers=args.workers)


if __name__ == '__main__':
    patchgan_serve()
