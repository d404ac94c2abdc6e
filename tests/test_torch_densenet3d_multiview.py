"""The port's DenseNet3D and MultiView ResNet against the JAX package's, on
the CPU.

Each JAX module is initialized, every BN randomized, and its variables
carried into the port with ``state_dict_from_flax`` (strict load); both run
the same seeded clip in f32: one ``MultiViewConv`` at 2e-4 (kernel 1, 3
and 7, with and without its bias), ``MVResNet`` (basic and bottleneck) and
``DenseNet3D`` at depth (1, 1, 1, 1) at 2e-3. ``densenet3d121``'s keys and
shapes equal the JAX export's without a forward, and its hosted-file
rename (``classifier``) loads strict. The nine new factories register
with JAX's signatures.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.models.densenet3d import DenseNet3D as JaxDenseNet3D
from pretorched_tpu.models.multiview import MVResNet as JaxMVResNet
from pretorched_tpu.models.multiview import MultiViewConv as JaxMultiViewConv
from pretorched_tpu.zoo.convert import to_torch_state_dict
from pretorched_tpu_torch.models import densenet3d
from pretorched_tpu_torch.models.densenet3d import DenseNet3D
from pretorched_tpu_torch.models.multiview import MultiViewConv, MVResNet
from pretorched_tpu_torch.zoo.io import load_state_dict_into

from torch_port_helpers import (assert_near, one_torch_thread,  # noqa: F401
                                port_state_dict, randomize_bn, run_jax,
                                to_nt)

NEW = ('densenet3d121', 'densenet3d169', 'densenet3d201', 'densenet3d264',
       'mvresnet10', 'mvresnet18', 'mvresnet34', 'mvresnet50', 'soundnet8')


def _init(module, shape, seed=0):
    return jax.jit(module.init)(jax.random.key(seed),
                                np.zeros(shape, np.float32))


def _carry(jmodule, model, clip, seed=0):
    """JAX logits of ``clip`` (NCTHW) with every BN randomized, and the
    port's ``model`` holding the same weights (strict load)."""
    variables = randomize_bn(dict(_init(jmodule, to_nt(clip[:1]).shape)),
                             seed=seed)
    want = np.asarray(run_jax(jmodule.apply, variables, to_nt(clip)))
    model.load_state_dict(port_state_dict(variables), strict=True)
    return want, model.eval(), variables


@pytest.mark.parametrize('k,pad,bias', [(3, 1, True), (3, 1, False),
                                        (1, 0, False), (7, 3, True)])
def test_multiview_conv_matches_jax(k, pad, bias):
    """One weight read as the (1,k,k), (k,1,k), (k,k,1) views at stride
    (1, 2, 2), the bias in each view, the mixer's weights and bias
    random: the port's weighted sum of three cuDNN convs against the JAX
    ``lax.conv`` + ``dense``."""
    rng = np.random.RandomState(k + 10 * bias)
    clip = rng.randn(2, 4, 6, 9, 9).astype(np.float32)
    jmod = JaxMultiViewConv(features=5, kernel_size=k, stride=(1, 2, 2),
                            padding=pad, bias=bias)
    variables = jax.tree_util.tree_map(
        lambda v: rng.uniform(-0.5, 0.5, np.shape(v)).astype(np.float32),
        dict(_init(jmod, to_nt(clip).shape)))
    want = np.moveaxis(np.asarray(jmod.apply(variables, to_nt(clip))), -1, 1)
    conv = MultiViewConv(4, 5, k, stride=(1, 2, 2), padding=pad, bias=bias)
    conv.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        got = conv(torch.from_numpy(clip)).numpy()
    assert_near(got, want, 2e-4)


@pytest.mark.parametrize('block', ['basic', 'bottleneck'])
def test_mvresnet_matches_jax(block):
    """Every conv a ``MultiViewConv`` (the 7x7 stem, the blocks, shortcut
    B's downsample): the 4-D kernels map HWIO -> OIHW by ``ndim``; the
    first segment (stem + layer1) at 2e-4 and the logits at 2e-3; zeroing
    the stem's mixer moves the first segment."""
    clip = np.random.RandomState(1).randn(2, 3, 8, 32, 32).astype(np.float32)
    jmod = JaxMVResNet(block=block, layers=(1, 1, 1, 1), num_classes=12,
                       expansion=1 if block == 'basic' else 4)
    model = MVResNet(block, (1, 1, 1, 1), num_classes=12)
    want, model, variables = _carry(jmod, model, clip, seed=2)
    kernel = np.asarray(variables['params']['layer2.0.downsample.0']['kernel'])
    assert kernel.ndim == 4 and kernel.shape[:2] == (1, 1)
    np.testing.assert_array_equal(
        model.layer2[0].downsample[0].weight.detach().numpy(),
        np.transpose(kernel, (3, 2, 0, 1)))
    assert isinstance(model.conv1, MultiViewConv)
    assert model.conv1.weight.shape == (64, 3, 7, 7)
    want_seg = np.moveaxis(np.asarray(run_jax(
        lambda v, x: jmod.apply(v, x, stage_slice=(0, 1)), variables,
        to_nt(clip))), -1, 1)
    x = torch.from_numpy(clip)
    with torch.no_grad():
        seg = model(x, stage_slice=(0, 1)).numpy()
        assert_near(seg, want_seg, 2e-4)
        assert_near(model(x).numpy(), want, 2e-3)
        model.conv1.linear.weight.zero_()
        moved = model(x, stage_slice=(0, 1)).numpy()
    assert np.abs(moved - seg).max() > 0.1 * np.abs(seg).max()


def test_densenet3d_matches_jax():
    """Depth (1, 1, 1, 1), growth 16, 32 init features, 16 frames x 32 px:
    the nested ``norm`` / ``conv`` containers load the dotted keys, the
    transitions, the 3D ``norm5`` (the features at 2e-4) and the
    duration / size head pool."""
    clip = np.random.RandomState(3).randn(2, 3, 16, 32, 32).astype(np.float32)
    kw = dict(growth_rate=16, block_config=(1, 1, 1, 1), num_init_features=32,
              num_classes=12, sample_size=32, sample_duration=16)
    model = DenseNet3D(**kw)
    assert 'features.denseblock1.denselayer1.norm.1.weight' in \
        model.state_dict()
    jmod = JaxDenseNet3D(**kw)
    want, model, variables = _carry(jmod, model, clip, seed=4)
    want_f = np.moveaxis(np.asarray(run_jax(
        lambda v, x: jmod.apply(v, x, mode='features'), variables,
        to_nt(clip))), -1, 1)
    with torch.no_grad():
        got = model(torch.from_numpy(clip)).numpy()
        feats = model.features(torch.from_numpy(clip)).numpy()
    assert feats.shape == (2, 34, 1, 1, 1)
    assert_near(feats, want_f, 2e-4)
    assert_near(got, want, 2e-3)


def test_densenet3d121_keys_match_jax_export():
    """The port's ``densenet3d121`` state dict, with the hosted files'
    ``classifier``, has the keys and shapes of the JAX export (from a
    ``jax.eval_shape`` template, nothing run); a file in those keys loads
    strict through the factory's rename."""
    module = JaxDenseNet3D()
    shapes = jax.eval_shape(module.init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 16, 112, 112, 3),
                                                 np.float32))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      dict(shapes))
    export = to_torch_state_dict(template, renames={'last_linear':
                                                    'classifier'})
    model = pretorched_tpu_torch.densenet3d121(num_classes=1000)
    own = {('classifier' + k[len('last_linear'):]
            if k.startswith('last_linear') else k): tuple(v.shape)
           for k, v in model.state_dict().items()}
    assert own == {k: tuple(v.shape) for k, v in export.items()}
    assert len(own) == 727      # 58 dense layers of 12 tensors, and the rest
    assert model.input_ndim == 5 and model.metadata is None
    hosted = {k: torch.full(v.shape, 0.5) if v.dtype == np.float32
              else torch.from_numpy(v) for k, v in export.items()}
    missing, unexpected = load_state_dict_into(
        model, hosted, torch_renames=densenet3d.TORCH_RENAMES)
    assert (missing, unexpected) == ([], [])
    assert model.last_linear.weight[0, 0].item() == 0.5


def test_factories_register_as_in_jax():
    """All 102 factories; the nine new ones with JAX's signature and
    defaults, outside ``model_names`` and the aggregated settings."""
    assert set(pretorched_tpu_torch.MODEL_REGISTRY) == set(
        pretorched_tpu.MODEL_REGISTRY)
    assert len(pretorched_tpu_torch.MODEL_REGISTRY) == 102
    for name in NEW:
        assert pretorched_tpu_torch.__dict__[name] is \
            pretorched_tpu_torch.MODEL_REGISTRY[name], name
        assert name not in pretorched_tpu_torch.model_names, name
        assert name not in pretorched_tpu_torch.pretrained_settings, name
        sig = inspect.signature(pretorched_tpu_torch.MODEL_REGISTRY[name])
        want = inspect.signature(pretorched_tpu.MODEL_REGISTRY[name])
        assert ([(p.name, p.default) for p in sig.parameters.values()]
                == [(p.name, p.default) for p in want.parameters.values()])
    model = pretorched_tpu_torch.mvresnet50()
    assert model.num_classes == 400 and model.num_features == 2048
    assert isinstance(model.layer1[0].downsample[0], MultiViewConv)
    with pytest.raises(KeyError):
        pretorched_tpu_torch.mvresnet10(pretrained='kinetics-400')
