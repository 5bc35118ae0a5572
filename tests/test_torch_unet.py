"""The port's UNet against the JAX UNet: weights initialised in JAX and
carried across with ``state_dict_from_jax``, the JAX forward run with
every Pallas kernel in interpret mode, fp32 at rtol 1e-3 / atol 1e-4;
the key set and parameter count; npz checkpoints across packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchgan_tpu.models import UNet as JaxUNet
from patchgan_tpu.utils import checkpoint as jax_ckpt
from patchgan_tpu.utils.transfer import export_state_dict, \
    load_transfer_data as jax_load, unet_key_map as jax_unet_key_map
from patchgan_tpu_torch.models import UNet
from patchgan_tpu_torch.utils import checkpoint as ckpt
from patchgan_tpu_torch.utils.summary import count_params
from patchgan_tpu_torch.utils.transfer import (load_transfer_data,
                                               state_dict_from_jax,
                                               unet_key_map)

torch.set_num_threads(2)

NF, SIZE, BATCH, CLASSES = 16, 128, 2, 3


@pytest.fixture(scope='module')
def jax_model():
    model = JaxUNet(input_nc=3, output_nc=CLASSES, nf=NF, activation='relu',
                    final_act='softmax')
    # one jitted init program (eager flax init dispatches op by op)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, SIZE, SIZE, 3))))(jax.random.PRNGKey(0))['params']
    return model, jax.device_get(params)


def _port(params):
    model = UNet(3, CLASSES, nf=NF, activation='relu', final_act='softmax')
    model.load_state_dict(state_dict_from_jax(params))
    return model.eval()


def test_unet_forward_matches_jax(jax_model, monkeypatch):
    for gate in ('PATCHGAN_PALLAS', 'PATCHGAN_FUSED_CONV',
                 'PATCHGAN_FUSED_CONVT'):
        monkeypatch.setenv(gate, 'interpret')
    jmodel, params = jax_model
    x = np.random.default_rng(0).random((BATCH, SIZE, SIZE, 3),
                                        dtype=np.float32)
    want = np.asarray(jmodel.apply({'params': params}, jnp.asarray(x)))
    with torch.no_grad():
        got, hidden = _port(params)(
            torch.from_numpy(np.transpose(x, (0, 3, 1, 2))),
            return_hidden=True)
    assert got.dtype == torch.float32
    assert hidden.shape == (BATCH, 8 * NF, 1, 1)
    np.testing.assert_allclose(np.transpose(got.numpy(), (0, 2, 3, 1)),
                               want, rtol=1e-3, atol=1e-4)


def test_keys_and_parameter_count(jax_model):
    _, params = jax_model
    model = _port(params)
    assert set(model.state_dict()) == set(unet_key_map()) \
        == set(jax_unet_key_map())
    jax_count = sum(int(np.size(a)) for a in jax.tree.leaves(params))
    assert count_params(model) == jax_count


def test_npz_checkpoints_cross_load(jax_model, tmp_path):
    _, params = jax_model
    # JAX writes, the port loads
    jax_ckpt.save_state_dict(str(tmp_path / 'jax.npz'),
                             export_state_dict(params, jax_unet_key_map()))
    model = UNet(3, CLASSES, nf=NF)
    assert load_transfer_data(
        model, ckpt.load_state_dict(str(tmp_path / 'jax.npz')),
        verbose=False) == 14
    ref = state_dict_from_jax(params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    # the port writes, JAX loads
    ckpt.save_state_dict(str(tmp_path / 'port.npz'), model.state_dict())
    zeros = jax.tree.map(np.zeros_like, params)
    loaded, count = jax_load(
        zeros, jax_ckpt.load_state_dict(str(tmp_path / 'port.npz')),
        jax_unet_key_map(), verbose=False)
    assert count == 14
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_spatial_size_check():
    with pytest.raises(ValueError, match='multiples of 128'):
        UNet(3, 1, nf=4)(torch.zeros(1, 3, 96, 128))
