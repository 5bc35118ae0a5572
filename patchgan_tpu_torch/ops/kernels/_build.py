"""Builds the port's CUDA kernels with nvcc at first use and loads them
with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), into
the build directory (``utils.compilation_cache.build_dir()``:
``patchgan_tpu_torch/_build/`` unless ``PATCHGAN_COMPILATION_CACHE`` names
another). The file name carries a hash of the sources, shared headers and
flags, so an edit rebuilds. ``build()``
starts one nvcc per source at once and waits for all of them. Nothing is
downloaded; a failed build raises with nvcc's output.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ...utils.compilation_cache import build_dir

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, 'csrc')

KERNELS = ('norm_act', 'norm_act_bwd', 'conv_norm_act', 'convt_norm_act',
           'thin_conv')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_lock = threading.Lock()
_libs = {}
# ptxas report (registers, shared memory, spills) of each kernel built by
# this process
build_log = {}


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = [os.path.join(cuda_home, 'bin', 'nvcc')] if cuda_home \
        else []
    candidates += [shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def _library_path(name):
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith('.cuh'))
    for fname in [f'{name}.cu'] + headers:
        with open(os.path.join(CSRC, fname), 'rb') as f:
            h.update(fname.encode() + b'\0' + f.read())
    return os.path.join(build_dir(), f'{name}-{h.hexdigest()[:16]}.so')


def build(names=KERNELS):
    """Compile every kernel of ``names`` that has no current library,
    one nvcc process each, all started together."""
    procs = []
    for name in names:
        out = _library_path(name)
        if os.path.exists(out):
            continue
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp,
               os.path.join(CSRC, f'{name}.cu')]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
            continue
        os.replace(tmp, out)   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))


def load(name):
    """The ctypes handle of kernel library ``name``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _library_path(name)
            if not os.path.exists(path):
                build((name,))
            lib = _libs[name] = ctypes.CDLL(path)
        return lib


def check(rc, what):
    """Raise if a launcher returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')


def stream_of(t):
    """The raw handle of the current stream on t's device (the integer
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    building a Stream object on every launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def device_guard(t):
    """The device guard a launch on t's device needs: none when that
    device is already the current one."""
    import torch
    index = t.get_device()
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)
