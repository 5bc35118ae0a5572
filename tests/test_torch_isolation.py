"""The port stands alone: importing every module of it loads neither JAX
nor the JAX package, and no source of it (nor chip_smoke.py) imports
them."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'patchgan_tpu_torch')

_CHECK = r'''
import importlib, pkgutil, sys
import patchgan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    patchgan_tpu_torch.__path__, 'patchgan_tpu_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ('jax', 'flax', 'patchgan_tpu') or
             k.startswith(('jax.', 'flax.', 'patchgan_tpu.')))
print(len(names), bad)
'''


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, '-c', _CHECK], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(' ', 1)
    assert int(n) >= 20
    assert bad == '[]'


_IMPORT = re.compile(
    r'^\s*(import|from)\s+(jax|flax|patchgan_tpu)\b(?!_)', re.MULTILINE)


def test_sources_do_not_import_jax():
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith('.py')]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            assert not _IMPORT.search(f.read()), path

