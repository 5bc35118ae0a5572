"""Batched tiled and whole-image inference engine on one device or over
the cards of one process.

Port of ``patchgan_tpu/inference/engine.py``. Tiled mode, per image: the
(uint8 or float32) HWC image is uploaded once and normalised on the
device; tiles are gathered from the resident image; the generator runs
over them in power-of-two bucket chunks; the averaging stitch
scatter-adds each tile into a canvas and a hit count in the host loop's
tile order, so every pixel's float sums run in the same order as
``tiling.build_mask``; threshold and argmax run on the device. When
``PATCHGAN_S2D`` selects it and the tile size is even, the tiled forward
runs the generator in its space-to-depth boundary form
(``engine.py:269-297``, ``ops/s2d.py``) on the uploaded tiles and turns
its output back before the stitch.

Over a ``DeviceMesh`` of several devices (``parallel.default_mesh``, the
counterpart of JAX ``engine.py:185-240, 336-364, 538-578``), the engine
keeps one copy of the weights on each distinct device, rounds
``batch_size`` up to a multiple of the mesh size, and picks each bucket
as such a multiple. Every bucket is gathered on the mesh's first (home)
device and split into equal, contiguous shares, share k running on
device k; every share's forward is issued before any output is copied
back to home, where the stitch, the postprocess and the mask's copy run
as on one device, in the same order. ``predict_images`` concatenates the
tiles of a group of images through one bucketed forward, so a serve
micro-batch fills mesh-wide buckets, and stitches each image in its tile
order. The tiled forward takes the fused conv kernels' K split of
``SPLIT_BATCH`` tiles in every bucket and share, so a tile's output, and
so a mask, is the same bits on one card and over a mesh, alone or in a
group.

Spatial mode (``predict_image(mode='spatial')``, JAX ``engine.py:299-334,
596-656``): the whole image, zero-padded bottom and right to multiples of
128, goes through one plain-form forward (whatever ``PATCHGAN_S2D``
says), with the same threshold / argmax on the device; instance-norm
statistics are then the whole image's. Over a mesh of k devices whose
padded height splits into k bands of an even number of rows (JAX's
``ph % k == 0`` at any padded height), band r's rows go from pinned host
memory to device r and the generator's band forward
(``UNet.forward(..., mesh=)`` on the engine's
``parallel.spatial.BandThreads``: one host thread a device, kept for the
engine's life, halo rows and instance-norm sums copied between the
devices) runs on every device at once; each device thresholds, argmaxes
or bit-packs its band, and only those compact rows are copied to the
home device, stitched, and fetched as below. A lock holds one such
forward at a time, so concurrent callers do not mix their exchanges.
Where the height does not split, the whole image runs on the home device
and the engine warns once, as JAX's does.

Either way the mask comes back as uint8 labels (int64 above 256
classes), or bit-packed rows for a binary mask, in one device-to-host
copy per image: the engine queues it into pinned host memory right
after the image's work and records a CUDA event behind it, and the
handle's ``.result()`` waits on that event alone, not on the work other
images have queued on the device since (another request's forward, say).
``predict_image_async`` returns before that copy, so a caller can decode
and save neighbouring images while the device works.

The bucket chunk size is the cheapest for the tile count by a table of
measured forward throughput (``bucket_rates.json``, written on the card
by ``tools/bucket_rates.py``).
"""

import copy
import json
import math
import os
import threading
import warnings

import numpy as np
import torch

from ..models.unet import UNet
from ..ops.s2d import depth_to_space, s2d_enabled, space_to_depth
from ..parallel.mesh import DeviceMesh
from ..parallel.spatial import BandThreads, even_bands
from .tiling import crop_positions


def _round_up(n, m):
    return ((n + m - 1) // m) * m


# Generator-forward throughput by bucket size relative to bucket 16, as
# measured on the card and written to bucket_rates.json beside this
# module by ``python tools/bucket_rates.py --write``; PATCHGAN_BUCKET_RATES
# names another file. Only the ratios are used, to pick the cheapest
# bucket for a tile count. A missing or unreadable file falls back to a
# uniform table, which always yields bucket 8, the least padding, for
# any cap of at least 8.
_FALLBACK_BUCKET_REL_RATE = {8: 1.0, 16: 1.0, 32: 1.0, 64: 1.0, 128: 1.0}


def _load_bucket_rates():
    path = os.environ.get('PATCHGAN_BUCKET_RATES') or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'bucket_rates.json')
    try:
        with open(path) as f:
            rates = {int(k): float(v)
                     for k, v in json.load(f)['rel_rate'].items()}
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        rates = {}
    if rates and all(v > 0 for v in rates.values()):
        return rates
    return dict(_FALLBACK_BUCKET_REL_RATE)


_BUCKET_REL_RATE = _load_bucket_rates()

# The tiled forward runs the fused conv kernels (K2, K3) at the K split a
# batch of this many tiles takes, whatever its bucket or share: their
# sums then run in one order for a tile wherever it runs (alone, in a
# bucket of one card, a card's share of one, a group's), so its mask is
# the same bits. 32 is the least split that runs the buckets 32-128
# within 4% of each bucket's own split on the wgmma core; 8 cost them
# 7-13%, and the buckets 8 and 16 are host-bound at any split
# (``tools/split_batch.py``; PERF.md).
SPLIT_BATCH = 32


def _pick_bucket(n, cap, align=1):
    """Cheapest power-of-two bucket for an ``n``-tile batch: cost =
    padded tile count / relative throughput, over the buckets no larger
    than ``cap`` that are multiples of ``align`` (the mesh size); when
    the table has none, the tile count rounded up to a multiple of 8 and
    of ``align``, at most ``cap`` (JAX ``engine.py:78-100``)."""
    best = None
    for bs, rate in _BUCKET_REL_RATE.items():
        if bs > cap or bs % align:
            continue
        cost = _round_up(n, bs) / rate
        if best is None or cost < best[0] - 1e-9:
            best = (cost, bs)
    if best is None:
        return min(cap, _round_up(n, math.lcm(8, align)))
    return best[1]


def _pad_min_size(image, size):
    """Edge-pad an (H, W, C) image up to at least (size, size); the
    caller crops the stitched mask back to (H, W)."""
    h, w = image.shape[:2]
    if h >= size and w >= size:
        return image, (h, w)
    image = np.pad(image, ((0, max(0, size - h)), (0, max(0, size - w)),
                           (0, 0)), mode='edge')
    return image, (h, w)


def _pack_bits(mask):
    """(..., H, W) {0,1} mask -> (..., H, W // 8) uint8, 8 pixels a byte,
    big-endian within the byte (restored by ``np.unpackbits``)."""
    w = mask.shape[-1]
    m = mask.reshape(mask.shape[:-1] + (w // 8, 8)).to(torch.int32)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=mask.device)
    return (m * weights).sum(dim=-1).to(torch.uint8)


def _as_input(image):
    """uint8 passes through (divided by 255 on the device); any other
    dtype becomes float32."""
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image
    return image.astype(np.float32, copy=False)


class _PendingMask:
    """In-flight mask; ``.result()`` waits for its one host copy. ``host``
    is a CPU tensor: on the card, the pinned buffer the engine queued the
    compact mask's copy into, with ``event`` recorded behind the copy; on
    the CPU, the mask itself. ``cast`` restores the host dtype of
    ``build_mask`` (int64 labels, float32 binary); ``packed`` marks
    bit-packed rows."""

    def __init__(self, host, h, w, cast=None, packed=False, event=None):
        self._host, self._h, self._w = host, h, w
        self._cast = cast
        self._packed = packed
        self._event = event

    def result(self):
        if self._event is not None:
            self._event.synchronize()
        arr = self._host.numpy()
        if self._packed:
            arr = np.unpackbits(arr, axis=1)
        arr = arr[:self._h, :self._w]
        return arr.astype(self._cast) if self._cast is not None else arr


class _ReadyMask:
    """A finished mask in the same handle interface."""

    def __init__(self, mask):
        self._mask = mask

    def result(self):
        return self._mask


class _Job:
    """One image of a tiled group: its uploaded (C, hp, wp) view, the
    crop size (h, w), and its canvas and hit count on the home device."""

    def __init__(self, img, h, w, count):
        self.img, self.h, self.w, self.count = img, h, w, count
        self.canvas = None


class InferenceEngine:
    """Tiled and whole-image inference with ``generator`` (a UNet, or any
    module mapping (N, C, H, W) to (N, out_C, H, W)).

    ``params``: a state_dict or a module whose weights to load (None keeps
    the generator's own). The engine works on its own copy, with the
    weights cast once to the compute ``dtype`` (default: the generator's).
    ``device``: 'cuda' (default) or 'cpu'. ``mesh``: a ``DeviceMesh``
    (``parallel.default_mesh``) to run over several devices; its first
    device is then the engine's ``device``, and a ``device`` given beside
    it must be that one.
    """

    def __init__(self, generator, params=None, size=256, overlap=0.9,
                 threshold=0, batch_size=128, dtype=None, device=None,
                 mesh=None):
        if mesh is None:
            devices = (torch.device(device or 'cuda'),)
        elif not isinstance(mesh, DeviceMesh):
            raise TypeError(f'mesh must be a DeviceMesh '
                            f'(parallel.default_mesh), got '
                            f'{type(mesh).__name__}')
        else:
            devices = mesh.devices
            if device is not None and torch.device(device) != mesh.home:
                raise ValueError(f'device {device} is not the first device '
                                 f'of {mesh}')
        if any(d.type == 'cuda' for d in devices) and \
                not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no GPU is "
                               "available (pass device='cpu')")
        self.device = devices[0]
        self.n_devices = len(devices)
        model = copy.deepcopy(generator)
        if params is not None:
            if isinstance(params, torch.nn.Module):
                params = params.state_dict()
            model.load_state_dict(params)
        if dtype is not None:
            model.dtype = dtype
        dtype = getattr(model, 'dtype', torch.float32)
        # one eval copy a distinct device, cast once (JAX ``replicate``),
        # in NCHW whatever the generator's layout (a channels_last
        # Trainer's): the engine has no channels_last path yet
        replicas = {}
        for d in devices:
            if d not in replicas:
                src = model if not replicas else copy.deepcopy(model)
                replicas[d] = src.to(
                    device=d, dtype=dtype,
                    memory_format=torch.contiguous_format).eval()
        self._devices = devices
        self._models = [replicas[d] for d in devices]
        self.model = self._models[0]
        # only the UNet has the s2d form and the kernels' split
        self._s2d = (s2d_enabled() and size % 2 == 0
                     and isinstance(generator, UNet))
        self._split = ({'split_batch': SPLIT_BATCH}
                       if isinstance(generator, UNet) else {})
        self.size = size
        self.overlap = overlap
        self.threshold = threshold
        self.batch_size = _round_up(batch_size, self.n_devices)
        self._spatial_warned = False
        self._spatial_lock = threading.Lock()
        self._band_threads = None

    def _upload(self, arr, device=None):
        """Host array -> tensor on ``device`` (default home), uint8
        normalised to [0, 1] on the device."""
        device = device or self.device
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == 'cuda':
            t = t.pin_memory().to(device, non_blocking=True)
        if t.dtype == torch.uint8:
            t = t.to(torch.float32) / 255.0
        return t

    def _forward(self, tiles, k=0):
        """The fp32 output of mesh device ``k``'s replica on ``tiles``
        (on that device)."""
        model = self._models[k]
        if self._s2d:
            x = space_to_depth(tiles.to(model.dtype))
            return depth_to_space(model(x, s2d=True,
                                        **self._split)).float()
        return model(tiles, **self._split).float()

    def _forward_bucket(self, tiles):
        """A bucket's fp32 output on home. Over several devices the
        bucket is split into equal, contiguous shares, share k for device
        k. Every share's copy is queued on home before home's own forward
        (a copy to another card runs on home's stream), every forward
        before any output is copied back, and nothing here waits on the
        host, so the devices run their shares at once."""
        if self.n_devices == 1:
            return self._forward(tiles)
        shares = [share.to(d, non_blocking=True) for share, d in
                  zip(tiles.chunk(self.n_devices), self._devices)]
        outs = [self._forward(share, k) for k, share in enumerate(shares)]
        preds = torch.empty((tiles.shape[0],) + outs[0].shape[1:],
                            dtype=torch.float32, device=self.device)
        for part, out in zip(preds.chunk(self.n_devices), outs):
            part.copy_(out, non_blocking=True)
        return preds

    def _fetch(self, dev, h, w, cast=None, packed=False):
        """Handle of the compact device mask ``dev``: on the card its copy
        into pinned host memory is queued now, behind this image's work,
        and an event recorded after it."""
        if dev.device.type == 'cpu':
            return _PendingMask(dev, h, w, cast, packed)
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev.device))
        return _PendingMask(host, h, w, cast, packed, event)

    def _compact(self, probs):
        """(C, H, W) fp32 map on the device -> (its compact mask on the
        device, the host dtype to restore, bit-packed): threshold, then
        argmax to uint8 labels (int64 above 256 classes); a binary mask
        bit-packed when its width is a multiple of 8; host dtypes as
        ``build_mask``'s. Row r of the mask is row r of the map."""
        if self.threshold > 0:
            probs = (probs >= self.threshold).to(torch.float32)
        out_c = probs.shape[0]
        if out_c > 1:
            lab = probs.argmax(dim=0)
            return (lab.to(torch.uint8) if out_c <= 256 else lab, np.int64,
                    False)
        if self.threshold > 0:
            if probs.shape[-1] % 8 == 0:
                return _pack_bits(probs[0]), np.float32, True
            return probs[0].to(torch.uint8), np.float32, False
        return probs[0], None, False

    def _postprocess(self, probs, h, w):
        """(C, H, W) fp32 map on the device -> handle of its (h, w)
        mask (``_compact``)."""
        mask, cast, packed = self._compact(probs)
        return self._fetch(mask, h, w, cast, packed)

    @torch.inference_mode()
    def predict_tiles(self, crops):
        """(N, size, size, C) -> (N, size, size, out_C) numpy in input
        order, in bucket chunks (each split over the mesh), every chunk
        queued before the result is copied back."""
        crops = _as_input(crops)
        n = crops.shape[0]
        bs = _pick_bucket(n, self.batch_size, self.n_devices)
        padded = _round_up(n, bs)
        if padded != n:
            crops = np.concatenate(
                [crops, np.zeros((padded - n,) + crops.shape[1:],
                                 crops.dtype)], axis=0)
        x = self._upload(crops).permute(0, 3, 1, 2)
        outs = [self._forward_bucket(x[i:i + bs].contiguous())
                for i in range(0, padded, bs)]
        return torch.cat(outs)[:n].permute(0, 2, 3, 1).cpu().numpy()

    @torch.inference_mode()
    def _predict_tiled(self, images):
        """Handles of ``images``' tiled pipelines. Their tiles, in image
        order and each image's in tile order, run through the bucketed
        forward; after each chunk its tiles are stitched into their
        images' canvases on home, so every pixel's sums run in the order
        of one image alone."""
        size = self.size
        jobs, tiles = [], []
        for image in images:
            image, (h, w) = _pad_min_size(_as_input(image), size)
            hp, wp, _ = image.shape
            job = _Job(self._upload(image).permute(2, 0, 1), h, w,
                       torch.zeros((1, hp, wp), dtype=torch.float32,
                                   device=self.device))
            jobs.append(job)
            tiles += [(job, y, x)
                      for y, x in crop_positions(hp, wp, size, self.overlap)]
        n = len(tiles)
        bs = _pick_bucket(n, self.batch_size, self.n_devices)
        for c0 in range(0, n, bs):
            chunk = tiles[c0:c0 + bs]
            # bucket padding repeats the first tile; its output is unused
            gather = chunk + [tiles[0]] * (bs - len(chunk))
            preds = self._forward_bucket(torch.stack(
                [job.img[:, y:y + size, x:x + size] for job, y, x in gather]))
            for i, (job, y, x) in enumerate(chunk):
                if job.canvas is None:
                    job.canvas = torch.zeros(
                        (preds.shape[1],) + job.count.shape[1:],
                        dtype=torch.float32, device=self.device)
                job.canvas[:, y:y + size, x:x + size] += preds[i]
                job.count[:, y:y + size, x:x + size] += 1.0
        # full coverage gives count >= 1 on every pixel
        return [self._postprocess(job.canvas / job.count.clamp_min(1.0),
                                  job.h, job.w) for job in jobs]

    def predict_image_async(self, image):
        """Run one image's tiled pipeline on the device(s); the handle's
        ``.result()`` waits for its (H, W) mask's copy to the host."""
        return self._predict_tiled([image])[0]

    @torch.inference_mode()
    def predict_image_spatial(self, image):
        """(H, W, C) image -> (H, W) mask from one whole-image forward in
        the plain form: zero-padded bottom and right to multiples of 128,
        threshold / argmax on the device, one copy back, cropped. Over a
        mesh split by rows (the module's docstring) where the padded
        height splits; else on the home device (over a mesh it warns
        once)."""
        image = _as_input(image)
        h, w = image.shape[:2]
        ph, pw = _round_up(h, 128), _round_up(w, 128)
        padded = np.zeros((ph, pw, image.shape[2]), image.dtype)
        padded[:h, :w] = image
        k = self.n_devices
        if k > 1 and even_bands(ph, k):
            with self._spatial_lock:
                handle = self._spatial_bands(padded, h, w)
            return handle.result()
        if k > 1 and not self._spatial_warned:
            self._spatial_warned = True
            warnings.warn(
                f'spatial inference: padded height {ph} does not split '
                f'into {k} bands of an even number of rows over the '
                f'{k}-device mesh; falling back to a SINGLE-device '
                f'whole-image forward on {self.device}', stacklevel=3)
        x = self._upload(padded).permute(2, 0, 1)[None].contiguous()
        probs = self.model(x).float()[0]
        return self._postprocess(probs, h, w).result()

    def band_threads(self):
        """The engine's ``BandThreads``, one a mesh device, made at its
        first spatial forward split by rows."""
        if self._band_threads is None:
            self._band_threads = BandThreads(self.n_devices)
        return self._band_threads

    def _spatial_bands(self, padded, h, w):
        """Handle of the (h, w) mask of the padded HWC image, its rows
        split over the mesh: band r uploaded to device r, every band's
        forward and compact mask on its device at once, the compact rows
        copied into one mask on home."""
        k = self.n_devices
        rows = padded.shape[0] // k

        def band(mesh):
            r = mesh.spatial.rank
            with torch.inference_mode():
                x = self._upload(padded[r * rows:(r + 1) * rows],
                                 mesh.device).permute(2, 0, 1)[None]
                probs = self._models[r](x.contiguous(), mesh=mesh)
                return self._compact(probs.float()[0])

        bands = self.band_threads().run(self._devices, band)
        first, cast, packed = bands[0]
        mask = torch.empty((padded.shape[0],) + tuple(first.shape[1:]),
                           dtype=first.dtype, device=self.device)
        for part, (out, _, _) in zip(mask.chunk(k), bands):
            part.copy_(out, non_blocking=True)
        return self._fetch(mask, h, w, cast, packed)

    def predict_image(self, image, mode='tiled'):
        """(H, W, C) image of any size -> (H, W) mask. mode='tiled': the
        overlap tiling and averaging stitch (each tile normalised by its
        own statistics); mode='spatial': one whole-image forward."""
        if mode == 'spatial':
            return self.predict_image_spatial(image)
        return self.predict_image_async(image).result()

    def predict_images_async(self, images):
        """One handle per image, every pipeline started before any copy
        is waited for. On one device each image runs its own chunks; over
        several devices the group's tiles share mesh-wide buckets."""
        if self.n_devices > 1:
            return self._predict_tiled(images)
        return [self.predict_image_async(im) for im in images]

    def predict_images(self, images):
        return [h.result() for h in self.predict_images_async(images)]
