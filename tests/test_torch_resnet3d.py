"""The port's 3D ResNets against the JAX package's, and the weight carrier.

``resnet3d18`` uses shortcut A (strided identity + zero channel pad) and
``resnet3d50`` shortcut B (1x1 conv + BN); both are carried across with
``state_dict_from_flax`` after every BN of the JAX model is randomized.
"""

import numpy as np
import pytest
import torch

import pretorched_tpu
from pretorched_tpu_torch.zoo.convert import state_dict_from_flax

from torch_port_helpers import carry_model, randomize_bn
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize('name,shortcut', [('resnet3d18', 'A'),
                                           ('resnet3d50', 'B')])
def test_resnet3d_matches_jax(name, shortcut):
    x = np.random.RandomState(0).randn(1, 3, 8, 32, 32).astype(np.float32)
    _, model, want = carry_model(name, x)
    assert model.shortcut_type == shortcut
    assert any('downsample' in k for k in model.state_dict()) == (shortcut == 'B')
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_state_dict_from_flax_equals_jax_export():
    """Key for key and value for value what the JAX exporter writes (the
    hosted-checkpoint format, ``last_linear`` -> ``fc``)."""
    jmodel = pretorched_tpu.resnet3d10(num_classes=7, pretrained=None)
    jmodel.variables = randomize_bn(jmodel.variables)
    want = jmodel.export_torch_state_dict()
    got = state_dict_from_flax(jmodel.variables, renames={'last_linear': 'fc'})
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
