"""``.pth`` files: the port reads them with ``torch.load``
(``utils/checkpoint.load_state_dict``), the counterpart of the JAX
package's torch-free reader (``utils/torch_pickle.load_torch_pickle``,
used by its ``utils/checkpoint.py:31-32``). Files written here by
``torch.save``, in the zip form and the legacy one, with fp32, bf16, fp16
and int64 tensors and a strided view, load to the same values in both;
bf16 is widened to fp32 on the port's side, as the JAX reader widens it
(the legacy form takes no bf16 there: the JAX reader hands it to
``torch.load`` and numpy, which has no bf16)."""

import numpy as np
import pytest
import torch

from patchgan_tpu.utils import checkpoint as jax_checkpoint
from patchgan_tpu.utils.torch_pickle import load_torch_pickle
from patchgan_tpu_torch.utils.checkpoint import load_state_dict

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int64]


def _state(dtype, strided):
    g = torch.Generator().manual_seed(int(dtype.itemsize) + strided)
    base = torch.randn(6, 5, 4, 3, generator=g) * 7
    t = base.to(dtype)
    if strided:
        # a view whose storage holds more than its elements
        t = t.permute(3, 1, 0, 2)[1:, :, ::2]
        assert not t.is_contiguous()
    return {'model.DownConv0.weight': t, 'model.scalar': base[0, 0, 0, 0]
            .to(dtype).clone(), 'model.UpConv1.weight': t.flip(0)}


def _widened(t):
    return t.float() if t.dtype == torch.bfloat16 else t


CASES = [(legacy, dtype, strided) for legacy in (False, True)
         for dtype in DTYPES for strided in (False, True)
         if not (legacy and dtype == torch.bfloat16)]


@pytest.mark.parametrize('legacy,dtype,strided', CASES, ids=[
    f"{'legacy' if c[0] else 'zip'}-{str(c[1])[6:]}-"
    f"{'strided' if c[2] else 'dense'}" for c in CASES])
def test_port_reads_pth_as_the_jax_reader(tmp_path, legacy, dtype, strided):
    state = _state(dtype, strided)
    path = str(tmp_path / 'weights.pth')
    torch.save(state, path, _use_new_zipfile_serialization=not legacy)
    with open(path, 'rb') as f:
        assert (f.read(2) == b'PK') != legacy
    got = load_state_dict(path)
    want = load_torch_pickle(path)
    assert set(got) == set(want) == set(state)
    for k, t in state.items():
        assert got[k].dtype == dtype and torch.equal(got[k], t)
        port = _widened(got[k]).numpy()
        assert port.dtype == want[k].dtype and port.shape == want[k].shape
        np.testing.assert_array_equal(port, want[k], err_msg=k)
    # the JAX package's own loader takes .pth through the same reader
    jax_side = jax_checkpoint.load_state_dict(path)
    for k in state:
        np.testing.assert_array_equal(_widened(got[k]).numpy(), jax_side[k])
