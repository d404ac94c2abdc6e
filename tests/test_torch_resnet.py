"""The port's 2D ResNet (``pretorched_tpu_torch/models/resnet.py``) against
the JAX package's, on the CPU.

Full-depth ``resnet18`` and ``resnet50`` at 64 px with every BN randomized
and the weights carried by ``state_dict_from_flax`` (strict load): f32
logits and features at 2e-3, one JAX backbone compile each. The variants
the class carries for later families, on a narrow net, at 2e-4. A
torchvision-layout ``.pth`` (``fc.*`` keys) written by the JAX exporter
loads into the factory strictly.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.models.resnet import ResNet as JaxResNet
from pretorched_tpu.zoo.convert import save_torch_checkpoint
from pretorched_tpu_torch.models.layers import SpaceToDepthConv
from pretorched_tpu_torch.models.resnet import ResNet

from torch_port_helpers import port_state_dict, randomize_bn, to_numpy_tree
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _carry(name):
    jmodel = pretorched_tpu.__dict__[name](num_classes=1000, pretrained=None)
    jmodel.variables = randomize_bn(jmodel.variables, seed=1)
    x = np.random.RandomState(0).randn(2, 3, 64, 64).astype(np.float32)
    feats = np.asarray(jmodel.features(x))
    logits = np.asarray(jmodel.logits(feats))
    model = pretorched_tpu_torch.__dict__[name](num_classes=1000,
                                                pretrained=None).eval()
    model.load_state_dict(port_state_dict(jmodel.variables), strict=True)
    return jmodel, model, x, feats, logits


@pytest.fixture(scope='module')
def resnet18_pair():
    return _carry('resnet18')


@pytest.fixture(scope='module')
def resnet50_pair():
    return _carry('resnet50')


@pytest.mark.parametrize('pair', ['resnet18_pair', 'resnet50_pair'])
def test_full_depth_matches_jax(pair, request):
    _, model, x, feats, logits = request.getfixturevalue(pair)
    with torch.no_grad():
        got_f = model.features(torch.from_numpy(x))
        got = model(torch.from_numpy(x))
        np.testing.assert_allclose(model.logits(got_f).numpy(), got.numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert got_f.shape == feats.shape and got.shape == (2, 1000)
    np.testing.assert_allclose(got_f.numpy(), feats, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), logits, rtol=2e-3, atol=2e-3)


def test_factory_contract():
    model = pretorched_tpu_torch.resnet50(num_classes=1000, pretrained=None)
    ref = pretorched_tpu.resnet50(num_classes=1000, pretrained=None)
    assert model.input_ndim == ref.input_ndim == 4
    assert model.input_size == ref.input_size == [3, 224, 224]
    assert sum(p.numel() for p in model.parameters()) == 25557032
    for name in ('resnet18', 'resnet34', 'resnet50', 'resnet101',
                 'resnet152'):
        assert name in pretorched_tpu_torch.model_names
        assert (pretorched_tpu_torch.pretrained_settings[name]
                == pretorched_tpu.pretrained_settings[name])
    assert sorted(pretorched_tpu_torch.pretrained_settings['resnet50']) == [
        'imagenet', 'moments', 'places365']
    assert isinstance(ResNet('basic', (1, 1, 1, 1), s2d_stem=True).conv1,
                      SpaceToDepthConv)
    assert isinstance(ResNet('basic', (1, 1, 1, 1), s2d_stem=True,
                             conv_bias=True).conv1, torch.nn.Conv2d)
    with pytest.raises(ValueError, match='num_classes'):
        pretorched_tpu_torch.resnet18(num_classes=10, pretrained='imagenet')


def test_jax_inits():
    """Convs and the head start from the JAX package's init: uniform in
    +-1/sqrt(fan_in), biases zero."""
    model = ResNet('basic', (1, 1, 1, 1), num_classes=10, conv_bias=True)
    from pretorched_tpu_torch.models.layers import init_parameters
    init_parameters(model, torch.Generator().manual_seed(0))
    for name in ('conv1', 'layer2.0.conv2', 'layer2.0.downsample.0',
                 'last_linear'):
        m = model.get_submodule(name)
        fan_in = m.weight[0].numel()
        w = m.weight.abs()
        assert w.max() <= fan_in ** -0.5 and w.max() > 0.9 * fan_in ** -0.5
        assert not m.bias.any()


VARIANTS = {
    'conv_bias': (dict(conv_bias=True), 64),
    'stride_on_conv1': (dict(stride_on='conv1'), 64),
    'stem_pool_ceil': (dict(stem_pool='ceil'), 64),
    'logits_pool_avg7': (dict(logits_pool='avg7'), 224),   # 7x7 features
    'inner_width_mult': (dict(inner_width_mult=2), 64),
    'no_bn': (dict(no_bn=True, conv_bias=True), 64),
    'basic': (dict(block='basic'), 64),
    's2d_stem': (dict(s2d_stem=True), 64),
}


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_block_variants_match_jax(variant):
    kw, size = VARIANTS[variant]
    kw = dict(dict(block='bottleneck', layers=(1, 2, 1, 1),
                   width_per_stage=(8, 8, 16, 16), num_classes=7), **kw)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, size, size).astype(np.float32)
    jmod = JaxResNet(**kw)
    xt = np.moveaxis(x, 1, -1)
    variables = to_numpy_tree(jmod.init(jax.random.key(0), xt))
    if kw.get('no_bn'):
        assert 'batch_stats' not in variables
    else:
        variables = randomize_bn(variables, seed=4)
    _randomize_biases(variables['params'], rng)    # flax starts them at 0
    want = np.asarray(jmod.apply(variables, xt))
    model = ResNet(**kw).eval()
    model.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 7)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _randomize_biases(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomize_biases(v, rng)
        elif k == 'bias':
            tree[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)


def test_torchvision_pth_loads_strict(resnet18_pair, tmp_path, monkeypatch):
    """A torchvision-layout checkpoint (``fc.*`` keys, plain state_dict),
    written by the JAX package's exporter, loads into ``resnet18(
    pretrained='imagenet')`` with every key used."""
    jmodel, _, x, _, logits = resnet18_pair
    url = pretorched_tpu_torch.pretrained_settings['resnet18']['imagenet'][
        'url']
    (tmp_path / 'weights').mkdir()
    path = tmp_path / 'weights' / url.rsplit('/', 1)[-1]
    save_torch_checkpoint(jmodel.variables, str(path),
                          renames={'last_linear': 'fc'})
    keys = torch.load(str(path), weights_only=True).keys()
    assert 'fc.weight' in keys and not any('last_linear' in k for k in keys)
    monkeypatch.setenv('PRETORCHED_HOME', str(tmp_path))
    monkeypatch.setenv('PRETORCHED_STRICT_WEIGHTS', '1')
    with warnings.catch_warnings():
        warnings.simplefilter('error')      # every key used: no warning
        model = pretorched_tpu_torch.resnet18(pretrained='imagenet').eval()
    assert model.settings['num_classes'] == 1000
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, logits, rtol=2e-3, atol=2e-3)


def test_remat_gives_the_same_gradients():
    torch.manual_seed(0)
    a = ResNet('bottleneck', (1, 1, 1, 1), width_per_stage=(8, 8, 8, 8),
               num_classes=3)
    b = ResNet('bottleneck', (1, 1, 1, 1), width_per_stage=(8, 8, 8, 8),
               num_classes=3, remat=True)
    b.load_state_dict(a.state_dict())
    x = torch.randn(2, 3, 32, 32)
    for m in (a, b):
        m.train()
        m(x).square().sum().backward()
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pb.grad, pa.grad, rtol=1e-5, atol=1e-6,
                                   msg=name)
