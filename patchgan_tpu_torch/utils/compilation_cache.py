"""The directory the port's native code builds into.

Port of ``patchgan_tpu/utils/compilation_cache.py``'s gate
(``:28-33, 64-104``). The JAX package keeps XLA's compiled programs in a
persistent cache; the port compiles its CUDA kernels
(``ops/kernels/_build.py``) and its JPEG / PNG decoder (``data/native.py``)
once and keeps the libraries, named by a hash of their sources and flags,
in one directory. ``PATCHGAN_COMPILATION_CACHE`` chooses it, with the JAX
module's precedence:

- a path: that directory, created if missing (a read-only install builds
  elsewhere);
- ``off``, ``0`` or ``false``: a fresh temporary directory for this
  process, removed when it exits, so every run builds anew (the
  counterpart of a disabled cache);
- unset or empty: ``patchgan_tpu_torch/_build/`` beside the package.

The variable is read once, at the first build of a process. The JAX
module's ``cache_bypass`` has no counterpart: it exists because a cache
round trip strips XLA's custom layouts, and nothing in the port rewrites
a library it loads.
"""

import atexit
import os
import shutil
import tempfile
import threading

ENV = 'PATCHGAN_COMPILATION_CACHE'
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), '_build')
OFF = ('off', '0', 'false')

_lock = threading.Lock()
_dir = None


def resolve(value):
    """The directory ``PATCHGAN_COMPILATION_CACHE=value`` names, or None
    for a fresh temporary one (``off``)."""
    value = (value or '').strip()
    if value.lower() in OFF:
        return None
    return os.path.abspath(os.path.expanduser(value)) if value \
        else DEFAULT_DIR


def build_dir():
    """The build directory of this process (see the module's docstring),
    created if missing."""
    global _dir
    with _lock:
        if _dir is None:
            path = resolve(os.environ.get(ENV))
            if path is None:
                path = tempfile.mkdtemp(prefix='patchgan_build_')
                atexit.register(shutil.rmtree, path, True)
            os.makedirs(path, exist_ok=True)
            _dir = path
        return _dir
