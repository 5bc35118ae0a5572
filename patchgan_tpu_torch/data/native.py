"""ctypes bindings for the native JPEG / PNG decode + resize library.

Port of ``patchgan_tpu/data/native.py``. ``data/_native/imgio.cpp`` (the
port's own copy) is compiled with g++ against the system libjpeg and
libpng at first use into ``patchgan_tpu_torch/_build/``, under a name
that carries a hash of the source and flags, so an edit rebuilds. The
entry points are those of the JAX module: ``native_available``,
``decode_jpeg_rgb[_u8]`` and ``decode_png_gray[_u8]``, each with its PIL
path, taken when the library cannot be built (no compiler, no libjpeg
headers), when ``PATCHGAN_NATIVE_IO=off`` (read at every call), or when
the library rejects a file. ``native_status()`` says which and why.
ctypes releases the GIL for the call, so the loader's threads decode in
parallel.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), '_native',
                    'imgio.cpp')
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), '_build')
_FLAGS = ('-O3', '-fPIC', '-shared')
_LIBS = ('-ljpeg', '-lpng')

_lock = threading.Lock()
_lib = None
_error = None   # why the library is unavailable, once a build failed


def _library_path():
    h = hashlib.sha256(' '.join(_FLAGS + _LIBS).encode())
    with open(_SRC, 'rb') as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f'libpatchgan_imgio-{h.hexdigest()[:16]}'
                                    '.so')


def _build(out):
    """g++ into a file of this process, then an atomic rename: threads
    and worker processes building at once never load half a file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.{threading.get_ident()}.tmp'
    proc = subprocess.run(['g++', *_FLAGS, '-o', tmp, _SRC, *_LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        errors = [line.strip() for line in proc.stderr.splitlines()
                  if 'error' in line] or [proc.stderr.strip()]
        raise RuntimeError(f'g++ exited {proc.returncode}: '
                           f'{"; ".join(errors)[:300]}')
    os.replace(tmp, out)


def _load():
    """The library, or None: PATCHGAN_NATIVE_IO=off, or the build failed
    (remembered, with its reason, in ``_error``)."""
    global _lib, _error
    if os.environ.get('PATCHGAN_NATIVE_IO', 'on') == 'off':
        return None
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            path = _library_path()
            try:
                lib = ctypes.CDLL(path) if os.path.exists(path) else None
            except OSError:   # built on a machine with other libraries
                lib = None
            if lib is None:
                _build(path)
                lib = ctypes.CDLL(path)
            info = [ctypes.c_char_p, ctypes.c_long,
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.pg_jpeg_info.argtypes = info
            lib.pg_png_info.argtypes = info
            for fn, ctype in (
                    (lib.pg_jpeg_decode_rgb_resize, ctypes.c_float),
                    (lib.pg_jpeg_decode_rgb_resize_u8, ctypes.c_uint8),
                    (lib.pg_png_decode_gray_resize, ctypes.c_int32)):
                fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                               ctypes.c_int, ctypes.POINTER(ctype)]
            _lib = lib
        except Exception as e:   # no g++, no libjpeg / libpng headers
            _error = f'{type(e).__name__}: {e}'
    return _lib


def native_available():
    return _load() is not None


def native_status():
    """'built', or 'unavailable: <reason>' (the PIL paths decode)."""
    if _load() is not None:
        return 'built'
    if os.environ.get('PATCHGAN_NATIVE_IO', 'on') == 'off':
        return 'unavailable: PATCHGAN_NATIVE_IO=off'
    return f'unavailable: {_error}'


def _decode(lib, info, decode, path, size, shape, dtype, ctype):
    """Read ``path`` and run ``decode`` into a new (oh, ow) + ``shape``
    array, (size, size) or the file's own size; None if the library
    rejects the file."""
    with open(path, 'rb') as f:
        data = f.read()
    h, w = ctypes.c_int(), ctypes.c_int()
    if info(data, len(data), ctypes.byref(h), ctypes.byref(w)):
        return None
    oh, ow = (size, size) if size else (h.value, w.value)
    out = np.empty((oh, ow) + shape, dtype=dtype)
    if decode(data, len(data), oh, ow,
              out.ctypes.data_as(ctypes.POINTER(ctype))):
        return None
    return out


def decode_jpeg_rgb(path, size=None):
    """A JPEG as float32 HWC RGB in [0, 1], resized (bilinear,
    align_corners=False) to (size, size) when ``size`` is given."""
    lib = _load()
    out = None if lib is None else _decode(
        lib, lib.pg_jpeg_info, lib.pg_jpeg_decode_rgb_resize, path, size,
        (3,), np.float32, ctypes.c_float)
    return _pil_jpeg(path, size) if out is None else out


def decode_jpeg_rgb_u8(path, size=None):
    """A JPEG as uint8 HWC RGB, resized (bilinear, rounded) when ``size``
    is given: a quarter of the float32 bytes to the card, which divides
    by 255 there."""
    lib = _load()
    out = None if lib is None else _decode(
        lib, lib.pg_jpeg_info, lib.pg_jpeg_decode_rgb_resize_u8, path, size,
        (3,), np.uint8, ctypes.c_uint8)
    return _pil_jpeg_u8(path, size) if out is None else out


def decode_png_gray(path, size=None):
    """A grayscale PNG as int32 HW, NEAREST-resized when ``size`` is
    given."""
    lib = _load()
    out = None if lib is None else _decode(
        lib, lib.pg_png_info, lib.pg_png_decode_gray_resize, path, size, (),
        np.int32, ctypes.c_int32)
    return _pil_png(path, size) if out is None else out


def decode_png_gray_u8(path, size=None):
    """``decode_png_gray`` as uint8 (a grey value fits)."""
    return decode_png_gray(path, size).astype(np.uint8)


def _pil_jpeg_u8(path, size):
    from PIL import Image
    with Image.open(path) as im:
        img = im.convert('RGB')
        if size:
            img = img.resize((size, size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


def _pil_jpeg(path, size):
    return _pil_jpeg_u8(path, size).astype(np.float32) / 255.0


def _pil_png(path, size):
    from PIL import Image
    with Image.open(path) as im:
        mask = im.convert('L')
        if size:
            mask = mask.resize((size, size), Image.NEAREST)
        return np.asarray(mask, dtype=np.int32)
