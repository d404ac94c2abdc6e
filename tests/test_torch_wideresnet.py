"""The port's WideResNet-50-2 and its hosted-file readers against the JAX
package's, on the CPU.

``wideresnet50`` (BN-free, conv biases, inner widths doubled, the 7x7
average-pool head) carries its seeded weights into the JAX ``ResNet`` of
the same fields: ``features`` at full depth and width of a 64 px image,
``logits`` of a seeded 7x7 map, at 2e-3 (whole nets). The readers:
``load_torch_state_dict`` on a nested hickle-style HDF5 file written here
with ``h5py`` (datasets at the root, under hickle's ``data`` group and in
nested groups, and a string dataset, which only the JAX reader keeps) and
on an ``.npz``, each read against the JAX loader on the same file; the
factory loading a hosted ``.hkl`` in the export's key layout
(``hkl_renames``) tensor for tensor; and the error that names ``h5py``
when it is missing.
"""

import sys

import numpy as np
import pytest
import torch

import pretorched_tpu_torch
from pretorched_tpu.models.resnet import ResNet as JaxResNet
from pretorched_tpu.models.wideresnet import hkl_renames as jax_renames
from pretorched_tpu.zoo import io as jax_io
from pretorched_tpu_torch.models.wideresnet import (LAYERS, hkl_renames,
                                                    pretrained_settings)
from pretorched_tpu_torch.zoo import io

from torch_port_helpers import (assert_metadata_like_jax, assert_near,
                                features_and_head)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def test_wideresnet50_matches_jax():
    model = pretorched_tpu_torch.wideresnet50(num_classes=10)
    assert model.settings is None            # pretrained=None by default
    assert_metadata_like_jax(model, 'wideresnet50')
    assert not any('bn' in k for k in model.state_dict())
    jmodule = JaxResNet(block='bottleneck', layers=LAYERS, num_classes=10,
                        inner_width_mult=2.0, conv_bias=True, no_bn=True,
                        logits_pool='avg7')
    (gf, wf), (gl, wl) = features_and_head(model, jmodule, 64, 7, 224)
    assert gf.shape == (1, 2048, 2, 2)
    assert model.layer1[0].conv2.out_channels == 128
    assert_near(gf, wf, 2e-3)
    assert_near(gl, wl, 2e-3)
    assert hkl_renames() == jax_renames()


def _write_nested_hkl(path):
    import h5py

    rng = np.random.RandomState(0)
    arrays = {'conv0.weight': rng.randn(4, 3, 3, 3).astype(np.float32),
              'fc.bias': rng.randn(5).astype(np.float32),
              'group0.block0.conv0.weight': rng.randn(2, 4, 1, 1),
              'steps': np.arange(3, dtype=np.int64)}
    with h5py.File(str(path), 'w') as f:
        f.create_dataset('conv0.weight', data=arrays['conv0.weight'])
        f.create_group('data').create_dataset('fc.bias',
                                              data=arrays['fc.bias'])
        f.create_group('group0').create_group('block0').create_dataset(
            'conv0.weight', data=arrays['group0.block0.conv0.weight'])
        f.create_dataset('steps', data=arrays['steps'])
        f.create_dataset('type', data='hickle')
    return arrays


def test_hkl_reader_matches_jax(tmp_path):
    path = tmp_path / 'nested.hkl'
    arrays = _write_nested_hkl(path)
    got = io.load_torch_state_dict(path)
    want = jax_io.load_torch_state_dict(path)
    assert set(got) == set(arrays) == set(want) - {'type'}
    for key, value in got.items():
        assert isinstance(value, torch.Tensor), key
        np.testing.assert_array_equal(value.numpy(), want[key])
        np.testing.assert_array_equal(value.numpy(), arrays[key])
    assert got['group0.block0.conv0.weight'].dtype == torch.float64


def test_npz_reader_matches_jax(tmp_path):
    path = tmp_path / 'w.npz'
    arrays = {'a.weight': np.ones((2, 3), np.float32),
              'b.running_var': np.arange(4, dtype=np.float32)}
    np.savez(path, **arrays)
    got = io.load_torch_state_dict(path)
    want = jax_io.load_torch_state_dict(path)
    assert list(got) == list(want) == list(arrays)
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[key])


def test_factory_loads_the_hosted_hkl(tmp_path, monkeypatch):
    """A file in the hosted export's keys (``conv0``, ``group{g}.block{i}
    .conv{0,1,2}``, ``conv_dim``, ``fc``) where the settings' URL names it:
    every tensor lands on the port's key ``hkl_renames`` maps it from."""
    import h5py

    donor = pretorched_tpu_torch.wideresnet50(num_classes=1000)
    renames = hkl_renames()
    url = pretrained_settings['wideresnet50']['imagenet']['url']
    (tmp_path / 'weights').mkdir()
    with h5py.File(str(tmp_path / 'weights' / url.rsplit('/', 1)[-1]),
                   'w') as f:
        for key, value in donor.state_dict().items():
            prefix, leaf = key.rsplit('.', 1)
            f.create_dataset(f'{renames[prefix]}.{leaf}',
                             data=(value * 1.01).numpy())
        assert 'group3.block0.conv_dim.bias' in f and 'fc.weight' in f
    monkeypatch.setenv('PRETORCHED_HOME', str(tmp_path))
    monkeypatch.setenv('PRETORCHED_STRICT_WEIGHTS', '1')
    model = pretorched_tpu_torch.wideresnet50(pretrained='imagenet')
    assert model.settings is not None
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, donor.state_dict()[key] * 1.01,
                                   rtol=0, atol=0)


def test_hkl_without_h5py_names_the_package(tmp_path, monkeypatch):
    path = tmp_path / 'w.hkl'
    _write_nested_hkl(path)
    monkeypatch.setitem(sys.modules, 'h5py', None)     # import fails
    with pytest.raises(ImportError, match='h5py'):
        io.load_torch_state_dict(path)
