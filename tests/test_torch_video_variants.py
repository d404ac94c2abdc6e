"""The port's ``VideoResNet`` variants and their factories against the JAX
package's, on the CPU.

Each variant (``factored``, ``cardinality``, ``preact``, ``s2d_stem`` on a
plain and on a factored stem, shortcut A and B) is built at depth
(1, 1, 1, 1) in both packages, every BN of the JAX model randomized and the
weights carried across with ``state_dict_from_flax`` (strict load), and run
on 8-frame 32 px clips in f32: the first segment (stem + layer1, through
``stage_slice``) at 2e-4 and the logits at 2e-3. The four ``stage_slice``
segments compose to the whole forward bit for bit. The full-depth
``r2plus1d50`` and ``preact_resnet3d50`` go through ``carry_model``; the
registry and settings of the 24 new factories equal the JAX ones; and
``resneti3d50`` inflates a 2D ``resnet50`` ``.pth`` written here exactly as
the JAX converter does.
"""

import numpy as np
import jax
import pytest
import torch

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.models.resnet3d import VideoResNet as JaxVideoResNet
from pretorched_tpu_torch.models import resnet3d
from pretorched_tpu_torch.models.resnet3d import (PIPELINE_STAGE_PREFIXES,
                                                  FactoredConv3d, VideoResNet)
from pretorched_tpu_torch.zoo.convert import state_dict_from_flax

from torch_port_helpers import (carry_model, port_state_dict, randomize_bn,
                                to_nt, zeros_init)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

NARROW = (16, 16, 32, 32)
VARIANTS = {
    'factored basic': dict(block='basic', factored=True, width_per_stage=NARROW),
    'factored bottleneck': dict(block='bottleneck', factored=True,
                                width_per_stage=NARROW),
    'cardinality': dict(block='bottleneck', cardinality=8, expansion=2,
                        width_per_stage=(32, 32, 64, 64)),
    'preact basic': dict(block='basic', preact=True, width_per_stage=NARROW),
    'preact bottleneck': dict(block='bottleneck', preact=True,
                              width_per_stage=NARROW),
    'preact shortcut A': dict(block='basic', preact=True, shortcut_type='A'),
    's2d_stem': dict(block='bottleneck', s2d_stem=True, width_per_stage=NARROW),
    's2d_stem factored': dict(block='bottleneck', factored=True, s2d_stem=True,
                              width_per_stage=NARROW),
}


def _clip(n=2, seed=0):
    return np.random.RandomState(seed).randn(n, 3, 8, 32, 32).astype(
        np.float32)


def _pair(kw, x, seed=0):
    """The JAX module with BN randomized, its variables, and the port's
    module with the same weights (strict load, eval)."""
    kw = dict(kw, layers=(1, 1, 1, 1), num_classes=7)
    kw.setdefault('expansion', 1 if kw['block'] == 'basic' else 4)
    jmod = JaxVideoResNet(**kw)
    variables = randomize_bn(jax.jit(jmod.init)(jax.random.key(seed),
                                                to_nt(x[:1])), seed)
    model = VideoResNet(**kw).eval()
    model.load_state_dict(port_state_dict(variables), strict=True)
    return jmod, variables, model


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_variant_matches_jax(variant):
    x = _clip()
    jmod, variables, model = _pair(VARIANTS[variant], x)
    want_stage = np.moveaxis(np.asarray(jmod.apply(
        variables, to_nt(x), stage_slice=(0, 1))), -1, 1)
    want = np.asarray(jmod.apply(variables, to_nt(x)))
    with torch.no_grad():
        got_stage = model(torch.from_numpy(x), stage_slice=(0, 1)).numpy()
        got = model(torch.from_numpy(x)).numpy()
    assert got_stage.shape == want_stage.shape and got.shape == (2, 7)
    np.testing.assert_allclose(got_stage, want_stage, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_factored_names_and_widths():
    """R(2+1)D's trap: a bottleneck's 1x1x1 convs and its downsample are
    factored too; only the basic block's 3x3x3 convs stay plain."""
    bott = VideoResNet('bottleneck', (1, 1, 1, 1), factored=True)
    for name in ('conv1', 'layer1.0.conv1', 'layer1.0.conv2',
                 'layer1.0.conv3', 'layer2.0.downsample.0'):
        assert isinstance(bott.get_submodule(name), FactoredConv3d), name
    # the stem's intermediate width: floor(7*7*7*3*64 / (7*7*3 + 7*64))
    assert bott.conv1.spatial_conv.weight.shape == (110, 3, 1, 7, 7)
    assert bott.conv1.temporal_conv.weight.shape == (64, 110, 7, 1, 1)
    basic = VideoResNet('basic', (1, 1, 1, 1), factored=True)
    assert isinstance(basic.layer1[0].conv1, torch.nn.Conv3d)
    assert isinstance(basic.layer2[0].downsample[0], FactoredConv3d)
    keys = set(bott.state_dict())
    assert {'layer1.0.conv1.spatial_conv.weight', 'layer1.0.conv1.bn.weight',
            'layer1.0.conv1.temporal_conv.weight'} <= keys


def test_stage_slices_compose_to_the_forward():
    x = _clip(seed=1)
    _, variables, model = _pair(VARIANTS['s2d_stem factored'], x, seed=2)
    h = torch.from_numpy(x)
    with torch.no_grad():
        whole = model(h)
        for lo in range(4):
            h = model(h, stage_slice=(lo, lo + 1))
    assert torch.equal(h, whole)
    owners = [[p for p in PIPELINE_STAGE_PREFIXES if k.split('.')[0] in p]
              for k in model.state_dict()]
    assert all(len(o) == 1 for o in owners)
    with pytest.raises(ValueError, match='stage_slice'):
        model(h, stage_slice=(2, 2))


def test_s2d_stem_is_the_same_function():
    """The folded stem stores the plain stem's ``conv1.weight``: one state
    dict loads into both and gives the same logits (f32, 2e-5)."""
    x = torch.from_numpy(_clip(seed=3))
    for factored in (False, True):
        kw = dict(layers=(1, 1, 1, 1), factored=factored,
                  width_per_stage=NARROW, num_classes=7)
        plain = VideoResNet('bottleneck', **kw).eval()
        folded = VideoResNet('bottleneck', s2d_stem=True, **kw).eval()
        folded.load_state_dict(plain.state_dict(), strict=True)
        with torch.no_grad():
            torch.testing.assert_close(folded(x), plain(x), rtol=2e-5,
                                       atol=2e-5)


@pytest.mark.parametrize('name', ['r2plus1d50', 'preact_resnet3d50'])
def test_full_depth_factory_matches_jax(name):
    x = np.random.RandomState(4).randn(1, 3, 8, 32, 32).astype(np.float32)
    _, model, want = carry_model(name, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


NEW_NAMES = ([f'r2plus1d{d}' for d in (10, 18, 34, 50, 101, 152, 200)]
             + [f'preact_resnet3d{d}' for d in (10, 18, 34, 50, 101, 152, 200)]
             + [f'resnext3d{d}' for d in (10, 18, 34, 50, 101, 152, 200)]
             + ['wideresnet3d50', 'resneti3d50', 'trn'])


def test_new_factories_register_as_in_jax():
    assert len(NEW_NAMES) == 24
    for name in NEW_NAMES:
        assert name in pretorched_tpu.MODEL_REGISTRY, name
        assert pretorched_tpu_torch.__dict__[name] is \
            pretorched_tpu_torch.MODEL_REGISTRY[name], name
        assert (pretorched_tpu_torch.pretrained_settings.get(name)
                == pretorched_tpu.pretrained_settings.get(name)), name
        assert ((name in pretorched_tpu_torch.model_names)
                == (name in pretorched_tpu.model_names)), name
    ported = set(pretorched_tpu_torch.MODEL_REGISTRY)
    assert ported <= set(pretorched_tpu.MODEL_REGISTRY)
    assert set(pretorched_tpu_torch.model_names) == \
        set(pretorched_tpu.model_names) & ported
    model = pretorched_tpu_torch.resnext3d101(num_classes=400,
                                              pretrained=None)
    assert model.input_ndim == 5 and model.input_size == [3, 224, 224]
    assert model.num_features == 2048 and model.layer1[0].conv2.groups == 32
    wide = pretorched_tpu_torch.wideresnet3d50(num_classes=400, k=2,
                                               pretrained=None)
    assert wide.layer4[0].conv3.out_channels == 2048


def test_resneti3d50_inflates_a_2d_resnet50(tmp_path, monkeypatch):
    """A 2D ``resnet50`` ``.pth`` (the hosted moments file's name, written
    here from the port's resnet50) loads into both packages' resneti3d50:
    each 2D kernel broadcast over time, unscaled, key for key what the JAX
    converter makes of it."""
    from pretorched_tpu_torch.models.resnet import pretrained_settings
    donor = pretorched_tpu_torch.resnet50(num_classes=339, pretrained=None)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in donor.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=g))
    sd = {('fc' + k[len('last_linear'):] if k.startswith('last_linear')
           else k): v for k, v in donor.state_dict().items()}
    url = pretrained_settings['resnet50']['moments']['url']
    (tmp_path / 'weights').mkdir()
    torch.save(sd, tmp_path / 'weights' / url.rsplit('/', 1)[-1])
    monkeypatch.setenv('PRETORCHED_HOME', str(tmp_path))
    monkeypatch.setenv('PRETORCHED_STRICT_WEIGHTS', '1')
    model = pretorched_tpu_torch.resneti3d50()
    assert model.settings['num_classes'] == 339
    got = model.state_dict()
    w2 = donor.conv1.weight.detach()
    assert got['conv1.weight'].shape == (64, 3, 7, 7, 7)
    for t in range(7):
        assert torch.equal(got['conv1.weight'][:, :, t], w2)
    # every variable comes from the file (strict): the JAX factory starts
    # from zeros on a template instead of compiling its init
    from pretorched_tpu.core import factory as jfactory
    monkeypatch.setattr(jfactory, 'init_variables', zeros_init)
    jmodel = pretorched_tpu.resneti3d50()
    want = state_dict_from_flax(jmodel.variables)
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert resnet3d.resneti3d50 is pretorched_tpu_torch.resneti3d50
