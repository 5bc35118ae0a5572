"""``PATCHGAN_COMPILATION_CACHE`` chooses the directory the port builds
its CUDA kernels and its JPEG / PNG decoder into
(``utils/compilation_cache.py``): a path, created if missing; off, 0 or
false, a fresh temporary directory removed at exit (every spelling the
JAX package's gate takes as off); unset, ``patchgan_tpu_torch/_build/``.
``ops/kernels/_build.py`` and ``data/native.py`` both name their
libraries under it (paths only: no nvcc here)."""

import os
import subprocess
import sys

import pytest

from patchgan_tpu.utils import compilation_cache as jax_cache
from patchgan_tpu_torch.data import native
from patchgan_tpu_torch.ops.kernels import _build
from patchgan_tpu_torch.utils import compilation_cache as cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFF = ['off', 'OFF', '0', 'false', 'False']


@pytest.fixture
def fresh(monkeypatch):
    """build_dir() resolves again in the test, and the process's own
    directory is back after it."""
    monkeypatch.setattr(cache, '_dir', None)
    monkeypatch.delenv(cache.ENV, raising=False)


def test_unset_is_the_package_directory(fresh):
    want = os.path.join(ROOT, 'patchgan_tpu_torch', '_build')
    assert cache.resolve(None) == cache.resolve('') == want
    assert cache.build_dir() == want
    assert os.path.isdir(want)


def test_a_path_is_used_and_made(fresh, monkeypatch, tmp_path):
    target = tmp_path / 'read-write' / 'builds'
    monkeypatch.setenv(cache.ENV, str(target))
    assert cache.build_dir() == str(target)
    assert target.is_dir()
    # read once: a later change of the variable leaves the process's
    # directory as it was
    monkeypatch.setenv(cache.ENV, str(tmp_path / 'other'))
    assert cache.build_dir() == str(target)


@pytest.mark.parametrize('value', OFF)
def test_off_is_a_fresh_directory_like_the_jax_gate(fresh, monkeypatch,
                                                    value):
    """Every spelling the JAX gate reads as off (it then returns None
    before touching JAX's configuration) gives a fresh temporary
    directory of this process."""
    monkeypatch.setenv(cache.ENV, value)
    assert jax_cache.enable_persistent_cache() is None
    assert cache.resolve(value) is None
    path = cache.build_dir()
    assert os.path.isdir(path) and not os.listdir(path)
    assert not path.startswith(os.path.join(ROOT, 'patchgan_tpu_torch'))


def test_off_directory_is_removed_at_exit(tmp_path):
    env = dict(os.environ, PATCHGAN_COMPILATION_CACHE='off',
               TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, '-c', 'from patchgan_tpu_torch.utils.'
         'compilation_cache import build_dir; import os; d = build_dir(); '
         'open(os.path.join(d, "x.so"), "w").close(); print(d)'],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    path = out.stdout.strip()
    assert path.startswith(str(tmp_path))
    assert not os.path.exists(path)


@pytest.mark.parametrize('setting', ['path', 'unset', 'off'])
def test_kernels_and_decoder_name_their_libraries_under_it(
        fresh, monkeypatch, tmp_path, setting):
    if setting == 'path':
        monkeypatch.setenv(cache.ENV, str(tmp_path / 'b'))
    elif setting == 'off':
        monkeypatch.setenv(cache.ENV, 'off')
    where = cache.build_dir()
    for name in _build.KERNELS:
        path = _build._library_path(name)
        assert os.path.dirname(path) == where
        assert os.path.basename(path).startswith(f'{name}-')
    assert os.path.dirname(native._library_path()) == where
    if setting == 'path':
        assert where == str(tmp_path / 'b')
