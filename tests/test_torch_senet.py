"""The port's SENet family (``pretorched_tpu_torch/models/senet.py``)
against the JAX package's, on the CPU.

Each block kind at depth (1, 1, 1, 1) and full widths (the ``senet154``
stem and grouped 2x / 4x bottleneck with 3x3 projections, SE-ResNet's
stride on conv1, SE-ResNeXt's 32 groups; the six factories differ only in
their depths beyond these three), every BN randomized and every
SE bias drawn (flax starts them at zero), at 224 px (the head's fixed 7x7
pool): f32 logits at 2e-3, the whole-net tolerance of
``tests/test_full_network_parity.py``. One full-depth
``se_resnext50_32x4d`` at 224 px, batch 1. A hosted ``.pth`` in the
reference's key layout, written by the JAX exporter, loads into the
factory strictly. One ``make_train_step`` step of a reduced SE-ResNeXt
(4 groups, no dropout) against the JAX step: the port in f64 against JAX
in f32, as ``tests/test_torch_train.py`` explains, the loss at 2e-4 and
each tensor's change within 5% of the JAX change's largest element.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.models.senet import SENet as JaxSENet
from pretorched_tpu.parallel.train import make_train_step as jax_make_train_step
from pretorched_tpu.parallel.train import sgd_step_decay as jax_sgd_step_decay
from pretorched_tpu.zoo.convert import save_torch_checkpoint
from pretorched_tpu_torch.models.senet import CONFIGS, SENet
from pretorched_tpu_torch.parallel.train import make_train_step, sgd_step_decay

from torch_port_helpers import (assert_state_matches, port_state_dict,
                                randomize_bn, to_numpy_tree, to_nt)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

NAMES = ('senet154', 'se_resnet50', 'se_resnet101', 'se_resnet152',
         'se_resnext50_32x4d', 'se_resnext101_32x4d')


def _draw_biases(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _draw_biases(v, rng)
        elif k == 'bias':
            tree[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)


def _jax_variables(module, x, seed):
    variables = to_numpy_tree(jax.jit(module.init)(jax.random.key(0),
                                                   to_nt(x[:1])))
    variables = randomize_bn(variables, seed=seed)
    _draw_biases(variables['params'], np.random.RandomState(seed))
    return variables


@pytest.mark.parametrize('name', ['senet154', 'se_resnet50',
                                  'se_resnext50_32x4d'])
def test_block_kinds_match_jax(name):
    """Each of the three bottlenecks with its factory's other fields, at
    depth (1, 1, 1, 1)."""
    kw = dict(CONFIGS[name], layers=(1, 1, 1, 1), num_classes=12)
    x = np.random.RandomState(0).randn(2, 3, 224, 224).astype(np.float32)
    jmod = JaxSENet(**kw)
    variables = _jax_variables(jmod, x, seed=1)
    want = np.asarray(jax.jit(jmod.apply)(variables, to_nt(x)))
    model = SENet(**kw).eval()
    model.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        feats = model.features(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 12) and feats.shape[1:] == (
        2048, 7, 7)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_se_identity_matches_jax():
    """The JAX ablation field: every SE gate bypassed."""
    kw = dict(CONFIGS['se_resnet50'], layers=(1, 1, 1, 1), num_classes=5,
              se_identity=True)
    x = np.random.RandomState(1).randn(1, 3, 224, 224).astype(np.float32)
    jmod = JaxSENet(**kw)
    variables = _jax_variables(jmod, x, seed=2)
    want = np.asarray(jax.jit(jmod.apply)(variables, to_nt(x)))
    model = SENet(**kw).eval()
    model.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.fixture(scope='module')
def se_resnext50():
    jmodel = pretorched_tpu.se_resnext50_32x4d(num_classes=1000,
                                               pretrained=None)
    jmodel.variables = randomize_bn(jmodel.variables, seed=3)
    x = np.random.RandomState(2).randn(1, 3, 224, 224).astype(np.float32)
    return jmodel, x, np.asarray(jmodel(x))


def test_full_depth_se_resnext50_matches_jax(se_resnext50):
    jmodel, x, want = se_resnext50
    model = pretorched_tpu_torch.se_resnext50_32x4d(num_classes=1000,
                                                    pretrained=None).eval()
    model.load_state_dict(port_state_dict(jmodel.variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 1000)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_hosted_pth_loads_strict(se_resnext50, tmp_path, monkeypatch):
    """The reference's key layout (``layer0.conv1``, ``se_module.fc1``,
    ``last_linear``; what the JAX exporter writes) loads into
    ``se_resnext50_32x4d(pretrained='imagenet')`` with every key used."""
    jmodel, x, want = se_resnext50
    url = pretorched_tpu_torch.pretrained_settings['se_resnext50_32x4d'][
        'imagenet']['url']
    (tmp_path / 'weights').mkdir()
    path = tmp_path / 'weights' / url.rsplit('/', 1)[-1]
    save_torch_checkpoint(jmodel.variables, str(path))
    keys = torch.load(str(path), weights_only=True).keys()
    assert {'layer0.conv1.weight', 'layer1.0.se_module.fc1.bias',
            'layer4.2.conv2.weight', 'last_linear.weight'} <= set(keys)
    monkeypatch.setenv('PRETORCHED_HOME', str(tmp_path))
    monkeypatch.setenv('PRETORCHED_STRICT_WEIGHTS', '1')
    with warnings.catch_warnings():
        warnings.simplefilter('error')      # every key used: no warning
        model = pretorched_tpu_torch.se_resnext50_32x4d().eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_factories_match_jax():
    """The six factories, their settings and parameter counts (the port's
    ``conv2d`` keeps flax's conv fields: grouped convs, biases only where
    the JAX module has them)."""
    for name in NAMES:
        assert name in pretorched_tpu_torch.model_names
        assert (pretorched_tpu_torch.pretrained_settings[name]
                == pretorched_tpu.pretrained_settings[name])
    model = pretorched_tpu_torch.senet154(num_classes=1000, pretrained=None)
    assert model.input_ndim == 4 and model.input_size == [3, 224, 224]
    assert model.dropout.p == 0.2
    assert sum(p.numel() for p in model.parameters()) == 115088984
    model = pretorched_tpu_torch.se_resnext101_32x4d(num_classes=1000,
                                                     pretrained=None)
    assert model.dropout is None
    assert sum(p.numel() for p in model.parameters()) == 48955416
    with pytest.raises(ValueError, match='num_classes'):
        pretorched_tpu_torch.se_resnet50(num_classes=10,
                                         pretrained='imagenet')


TRAIN_ARCH = dict(block='se_resnext', layers=(1, 1, 1, 1), groups=4,
                  inplanes=64, input_3x3=False, downsample_kernel_size=1,
                  downsample_padding=0, num_classes=5)
SGD = dict(lr=1e-3, momentum=0.9, weight_decay=1e-4, decay_epochs=1,
           steps_per_epoch=2)


def test_train_step_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 224, 224).astype(np.float32)
    labels = np.array([1, 4], np.int64)
    jmod = JaxSENet(**TRAIN_ARCH)
    variables = _jax_variables(jmod, x, seed=5)
    tx = jax_sgd_step_decay(**SGD)
    step = jax_make_train_step(jmod, tx, donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    stats = jax.tree_util.tree_map(jnp.asarray, variables['batch_stats'])
    params, stats, _, metrics = step(params, stats, tx.init(params),
                                     jnp.asarray(to_nt(x)),
                                     jnp.asarray(labels), 0)
    final = {'params': to_numpy_tree(params),
             'batch_stats': to_numpy_tree(stats)}
    want_loss = float(metrics['loss'])

    model = SENet(**TRAIN_ARCH)
    model.load_state_dict(port_state_dict(variables), strict=True)
    model.double()
    opt, sched = sgd_step_decay(model.parameters(), **SGD)
    got = make_train_step(model, opt, sched)(
        torch.from_numpy(x).double(), torch.from_numpy(labels))
    assert model.training
    np.testing.assert_allclose(float(got['loss']), want_loss, rtol=2e-4)
    assert float(got['top1']) == float(metrics['top1'])
    assert_state_matches(model, final, variables)
