"""The port's ResNet relatives and torchvision family (FBResNet,
CaffeResNet, DenseNet, VGG, AlexNet, SqueezeNet) against the JAX package's,
on the CPU.

Each on carried weights with every BN randomized, at the sizes of the JAX
twins (``tests/test_torchvision_family.py``,
``tests/test_full_network_parity.py``): full-depth ``fbresnet18`` at 224 px
through both factories; CaffeResNet's stride-on-conv1, ceil-mode stem at
depth (1, 1, 1, 1); ``alexnet`` at 224 px and both SqueezeNets at 128 px
through both factories; the DenseNet of growth 8, blocks (2, 3, 2, 2)
at 224 px; VGG in configuration A with and without BN, its convs narrowed
below the last (the head's 512 x 7 x 7 stays) at 224 px. Logits at 2e-3
(whole nets), ``features`` of the split models too. Densenet's old dotted
keys are rewritten as the JAX converter rewrites them and load strictly.
Every factory's settings equal the JAX package's.
"""

import jax
import numpy as np
import pytest
import torch

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.models.densenet import DenseNet as JaxDenseNet
from pretorched_tpu.models.resnet import ResNet as JaxResNet
from pretorched_tpu.models.vgg import VGG as JaxVGG
from pretorched_tpu.zoo.convert import densenet_key_rewrite as jax_rewrite
from pretorched_tpu_torch.models.densenet import DenseNet
from pretorched_tpu_torch.models.resnet import ResNet
from pretorched_tpu_torch.models.vgg import VGG
from pretorched_tpu_torch.zoo.convert import densenet_key_rewrite
from pretorched_tpu_torch.zoo.io import load_state_dict_into

from torch_port_helpers import (carry_model, port_state_dict, randomize_bn,
                                to_numpy_tree, to_nt)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

NEW = ('resnext101_32x4d', 'resnext101_64x4d', 'fbresnet18', 'fbresnet34',
       'fbresnet50', 'fbresnet101', 'fbresnet152', 'cafferesnet101',
       'densenet121', 'densenet161', 'densenet169', 'densenet201', 'vgg11',
       'vgg11_bn', 'vgg13', 'vgg13_bn', 'vgg16', 'vgg16_bn', 'vgg19',
       'vgg19_bn', 'alexnet', 'squeezenet1_0', 'squeezenet1_1')
SMALL_DENSENET = dict(growth_rate=8, block_config=(2, 3, 2, 2),
                      num_init_features=16)
SMALL_VGG = (16, 'M', 32, 'M', 64, 64, 'M', 128, 128, 'M', 128, 512, 'M')


def _x(size, n=2):
    return np.random.RandomState(0).randn(n, 3, size, size).astype(
        np.float32)


def _carry(jmod, model, x, seed=1):
    """JAX ``jmod`` (jitted init, BN randomized) and ``model`` on the same
    weights; returns (variables, JAX logits, port logits)."""
    variables = randomize_bn(jax.jit(jmod.init)(jax.random.key(0),
                                                to_nt(x[:1])), seed=seed)
    want = np.asarray(jax.jit(jmod.apply)(variables, to_nt(x)))
    model.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    return variables, want, got


@pytest.mark.parametrize('name,size', [('fbresnet18', 224),
                                       ('alexnet', 224),
                                       ('squeezenet1_0', 128),
                                       ('squeezenet1_1', 128)])
def test_factory_matches_jax(name, size):
    x = _x(size)
    jmodel, model, want = carry_model(name, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        feats = model.features(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(feats, np.asarray(jmodel.features(x)),
                               rtol=2e-3, atol=2e-3)
    if name.startswith('squeezenet'):
        # the head is a conv: no last_linear on either side
        assert model.last_linear is None and jmodel.last_linear is None
        with pytest.raises(ValueError, match='no linear head'):
            model.reset_classifier(5)


def test_cafferesnet_matches_jax():
    kw = dict(layers=(1, 1, 1, 1), num_classes=10, stride_on='conv1',
              stem_pool='ceil', logits_pool='avg7')
    _, want, got = _carry(JaxResNet(block='bottleneck', **kw),
                          ResNet('bottleneck', **kw), _x(224))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    model = pretorched_tpu_torch.cafferesnet101(pretrained=None)
    assert (model.input_space, model.input_range) == ('BGR', [0, 255])


def test_densenet_matches_jax():
    x = _x(224)
    model = DenseNet(num_classes=10, **SMALL_DENSENET)
    variables, want, got = _carry(JaxDenseNet(num_classes=10,
                                              **SMALL_DENSENET), model, x)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    jfeats = JaxDenseNet(num_classes=10, **SMALL_DENSENET).apply(
        variables, to_nt(x), mode='features')
    with torch.no_grad():
        feats = model.features(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(feats, np.moveaxis(np.asarray(jfeats), -1, 1),
                               rtol=2e-3, atol=2e-3)


def test_densenet_old_keys_load():
    """The hosted format (``classifier``) with the old dotted keys
    (``norm.1``) loads strictly through the rewrite."""
    model = DenseNet(num_classes=10, **SMALL_DENSENET)
    sd = {k.replace('last_linear', 'classifier'): v
          for k, v in model.state_dict().items()}
    old = {}
    for k, v in sd.items():
        if k.endswith('num_batches_tracked'):   # older than BN's counter
            continue
        for a, b in (('.norm1.', '.norm.1.'), ('.conv1.', '.conv.1.'),
                     ('.norm2.', '.norm.2.'), ('.conv2.', '.conv.2.')):
            if 'denselayer' in k:
                k = k.replace(a, b)
        old[k] = v
    assert 'features.denseblock1.denselayer1.norm.1.weight' in old
    for k in old:
        assert densenet_key_rewrite(k) == jax_rewrite(k)
    fresh = DenseNet(num_classes=10, **SMALL_DENSENET)
    assert load_state_dict_into(fresh, old, torch_renames={
        'last_linear': 'classifier'}, key_rewrite=densenet_key_rewrite) == (
        [], [])
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


@pytest.mark.parametrize('use_bn', [False, True])
def test_vgg_matches_jax(use_bn):
    x = _x(224, n=1)
    model = VGG(SMALL_VGG, use_bn=use_bn, num_classes=10)
    variables, want, got = _carry(JaxVGG(cfg=SMALL_VGG, use_bn=use_bn,
                                         num_classes=10), model, x)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    jfeats = JaxVGG(cfg=SMALL_VGG, use_bn=use_bn, num_classes=10).apply(
        variables, to_nt(x), mode='features')
    with torch.no_grad():
        feats = model.features(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(feats, np.asarray(jfeats), rtol=2e-3,
                               atol=2e-3)


def test_settings_and_registry_match_jax():
    for name in NEW:
        assert name in pretorched_tpu_torch.MODEL_REGISTRY, name
        assert pretorched_tpu_torch.pretrained_settings.get(name) == \
            pretorched_tpu.pretrained_settings.get(name), name
    assert set(pretorched_tpu_torch.model_names) <= set(
        pretorched_tpu.model_names)
    with pytest.raises(ValueError, match='no hosted pretrained weights'):
        pretorched_tpu_torch.fbresnet18(pretrained='imagenet')
