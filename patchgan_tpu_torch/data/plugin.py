"""Custom-dataset plugin protocol.

Port of ``patchgan_tpu/data/plugin.py``: when the config's
``dataset.type`` is not ``'COCOStuff'``, a class of that name is loaded
from ``io.py`` in the current working directory.
"""

import importlib.util
import os


def load_dataset_class(type_name, cwd=None):
    path = os.path.join(cwd or os.getcwd(), 'io.py')
    try:
        spec = importlib.util.spec_from_file_location('io', path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    except FileNotFoundError:
        print("Make sure io.py is in the working directory!")
        raise
    try:
        return getattr(module, type_name)
    except AttributeError as e:
        print(f"io.py does not contain {type_name}")
        raise ImportError(str(e)) from e
