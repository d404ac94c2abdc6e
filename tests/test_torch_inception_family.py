"""The port's Inception family (``inceptionv3``, ``inceptionv4``,
``inceptionresnetv2``, ``bninception``) and ``xception`` against the JAX
package's, on the CPU, and the registry after the rest of the 2D zoo.

Each net carries the port's seeded weights (every BN randomized) into the
JAX module through the JAX converter on a ``jax.eval_shape`` template. A
net with a fixed head pool is held in two pieces (``features_and_head``):
``features`` at full depth and width of a 139 px image (299 px's odd /
even steps: 149, 147, 73, 71, 35, 17, 8 against 69, 67, 33, 31, 15, 7,
3), and ``logits`` of a seeded 8x8 map (7x7 for BN-Inception, whose
ceil-mode pools take any size: 96 px). Xception, whose head is global,
whole at 64 px. All at 2e-3 (whole nets). Inception-v3 in train mode: the
aux output and every BN's running statistics after one forward at 299 px,
against JAX's (the logits pass a dropout, which cannot match across
frameworks). The 1001-class hosted files of Inception-v4 and
Inception-ResNet-v2 lose their background row on an ``imagenet`` load, as
the JAX converter drops it.
"""

import importlib
import inspect
import warnings

import jax
import numpy as np
import pytest
import torch

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.models.bninception import BNInception
from pretorched_tpu.models.inception_v3 import InceptionV3
from pretorched_tpu.models.inceptionresnetv2 import InceptionResNetV2
from pretorched_tpu.models.inceptionv4 import InceptionV4
from pretorched_tpu.models.xception import Xception
from pretorched_tpu.zoo.convert import convert_state_dict

from torch_port_helpers import (assert_metadata_like_jax, assert_near,
                                features_and_head, jax_variables_from_port,
                                port_state_dict, randomize_port_bn, run_jax,
                                to_nt)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

# the 16 factories this slice ports, by module
NEW = {'inception_v3': ['inceptionv3'], 'inceptionv4': ['inceptionv4'],
       'inceptionresnetv2': ['inceptionresnetv2'],
       'bninception': ['bninception'], 'xception': ['xception'],
       'dpn': ['dpn68', 'dpn68b', 'dpn92', 'dpn98', 'dpn107', 'dpn131'],
       'mobilenet': ['mobilenetv2'], 'pnasnet': ['pnasnet5large'],
       'polynet': ['polynet'], 'vggm': ['vggm'],
       'wideresnet': ['wideresnet50']}
# the video and audio factories, the last ported
VIDEO_AND_AUDIO = {'densenet3d121', 'densenet3d169', 'densenet3d201',
                   'densenet3d264', 'mvresnet10', 'mvresnet18', 'mvresnet34',
                   'mvresnet50', 'soundnet8'}


@pytest.mark.parametrize('name,jax_cls,size,head,full,init_kwargs', [
    ('inceptionv3', InceptionV3, 139, 8, 299, {'train': True}),
    ('inceptionv4', InceptionV4, 139, 8, 299, None),
    ('inceptionresnetv2', InceptionResNetV2, 139, 8, 299, None),
    ('bninception', BNInception, 96, 7, 224, None),
], ids=['inceptionv3', 'inceptionv4', 'inceptionresnetv2', 'bninception'])
def test_features_and_head_match_jax(name, jax_cls, size, head, full,
                                     init_kwargs):
    model = pretorched_tpu_torch.__dict__[name](num_classes=10,
                                                pretrained=None)
    assert_metadata_like_jax(model, name)
    (gf, wf), (gl, wl) = features_and_head(
        model, jax_cls(num_classes=10), size, head, full,
        init_kwargs=init_kwargs)
    assert gf.shape[1] == model.num_features and gl.shape == (1, 10)
    assert_near(gf, wf, 2e-3)
    assert_near(gl, wl, 2e-3)


def test_xception_matches_jax():
    model = randomize_port_bn(pretorched_tpu_torch.xception(
        num_classes=10, pretrained=None)).eval()
    assert_metadata_like_jax(model, 'xception')
    assert model.scale == 0.8975
    x = np.random.RandomState(0).randn(2, 3, 64, 64).astype(np.float32)
    jmodule = Xception(num_classes=10)
    variables = jax_variables_from_port(jmodule, model.state_dict(),
                                        (1, 64, 64, 3))
    with torch.no_grad():
        assert_near(model(torch.from_numpy(x)).numpy(),
                    np.asarray(run_jax(jmodule.apply, variables, to_nt(x))),
                    2e-3)
        assert_near(model.features(torch.from_numpy(x)).numpy(),
                    np.moveaxis(np.asarray(run_jax(
                        lambda v, x: jmodule.apply(v, x, mode='features'),
                        variables, to_nt(x))), -1, 1), 2e-3)
    # the rep slots count the ReLUs: block1 starts without one
    assert model.block1.rep[0].conv1.groups == 64
    assert model.block2.rep[1].pointwise.out_channels == 256


def test_inceptionv3_train_mode_aux_and_bn_stats_match_jax():
    """Train mode: ``forward`` returns (logits, aux), eval mode the logits
    alone. The aux output and every BN's running statistics after one
    train-mode forward at 299 px agree with JAX's (2e-3, whole net)."""
    model = randomize_port_bn(pretorched_tpu_torch.inceptionv3(
        num_classes=10, pretrained=None))
    jmodule = InceptionV3(num_classes=10)
    variables = jax_variables_from_port(jmodule, model.state_dict(),
                                        (1, 299, 299, 3),
                                        init_kwargs={'train': True})
    x = np.random.RandomState(1).randn(2, 3, 299, 299).astype(np.float32)
    (_, want_aux), updates = run_jax(lambda v, x: jmodule.apply(
        v, x, train=True, mutable=['batch_stats'],
        rngs={'dropout': jax.random.key(0)}), variables, to_nt(x))
    with torch.no_grad():
        logits, aux = model.train()(torch.from_numpy(x))
        assert logits.shape == aux.shape == (2, 10)
        assert_near(aux.numpy(), np.asarray(want_aux), 2e-3)
        assert model.eval()(torch.from_numpy(x[:1])).shape == (1, 10)
    want = port_state_dict({'params': variables['params'],
                            'batch_stats': updates['batch_stats']})
    got = model.state_dict()
    stats = [k for k in want if k.endswith(('running_mean', 'running_var'))]
    assert len(stats) == 2 * 96
    for key in stats:
        assert_near(got[key].numpy(), want[key].numpy(), 2e-3)


@pytest.mark.parametrize('name,jax_cls', [
    ('inceptionv4', InceptionV4),
    ('inceptionresnetv2', InceptionResNetV2)], ids=['v4', 'resnet_v2'])
def test_background_row_dropped_like_jax(name, jax_cls, tmp_path,
                                         monkeypatch):
    """A 1001-class hosted file through the factory: ``imagenet`` (the
    default) loads every tensor but the first row of ``last_linear``, as
    the JAX converter's ``background_class_keys`` drops it."""
    check_background_row(name, jax_cls, 8, tmp_path, monkeypatch)


def check_background_row(name, jax_cls, head, tmp_path, monkeypatch):
    donor = randomize_port_bn(pretorched_tpu_torch.__dict__[name](
        num_classes=1001, pretrained=None), seed=3)
    sd = donor.state_dict()
    url = pretorched_tpu_torch.pretrained_settings[name]['imagenet']['url']
    (tmp_path / 'weights').mkdir()
    torch.save(sd, tmp_path / 'weights' / url.rsplit('/', 1)[-1])
    monkeypatch.setenv('PRETORCHED_HOME', str(tmp_path))
    monkeypatch.setenv('PRETORCHED_STRICT_WEIGHTS', '1')
    with warnings.catch_warnings():
        warnings.simplefilter('error')      # every key used: no warning
        model = pretorched_tpu_torch.__dict__[name]().eval()
    for key, value in model.state_dict().items():
        want = sd[key][1:] if key.startswith('last_linear') else sd[key]
        torch.testing.assert_close(value, want, rtol=0, atol=0)
    # the JAX converter on the head (the logits touch nothing else)
    width = model.num_features
    variables = convert_state_dict(
        {k: v.numpy() for k, v in sd.items() if k.startswith('last_linear')},
        {'params': {'last_linear': {'kernel': np.zeros((width, 1000),
                                                       np.float32),
                                    'bias': np.zeros(1000, np.float32)}}},
        background_class_keys=('last_linear',))
    np.testing.assert_array_equal(
        model.last_linear.weight.detach().numpy(),
        np.asarray(variables['params']['last_linear']['kernel']).T)
    fmap = np.random.RandomState(4).randn(1, width, head, head).astype(
        np.float32)
    want = np.asarray(jax_cls(num_classes=1000).apply(
        variables, to_nt(fmap), mode='logits'))
    with torch.no_grad():
        assert_near(model.logits(torch.from_numpy(fmap)).numpy(), want, 2e-3)


def test_registry_matches_jax():
    """All 62 of JAX's ``model_names``; all 102 of its factories, the
    nine video and audio ones among them; every new factory with JAX's
    signature and defaults, and its module's settings equal to JAX's
    (``vggm`` and ``wideresnet50`` outside ``model_names`` and outside the
    aggregated ``pretrained_settings``, as in JAX)."""
    assert set(pretorched_tpu_torch.model_names) == set(
        pretorched_tpu.model_names)
    assert len(pretorched_tpu_torch.model_names) == 62
    ported, jax_all = (set(pretorched_tpu_torch.MODEL_REGISTRY),
                       set(pretorched_tpu.MODEL_REGISTRY))
    assert ported == jax_all and VIDEO_AND_AUDIO <= ported
    assert len(ported) == 102
    for module, names in NEW.items():
        port_mod = importlib.import_module(
            f'pretorched_tpu_torch.models.{module}')
        jax_mod = importlib.import_module(f'pretorched_tpu.models.{module}')
        assert port_mod.pretrained_settings == jax_mod.pretrained_settings
        for name in names:
            assert (pretorched_tpu_torch.pretrained_settings.get(name)
                    == pretorched_tpu.pretrained_settings.get(name)), name
            assert ((name in pretorched_tpu_torch.model_names)
                    == (module not in ('vggm', 'wideresnet'))), name
            sig = inspect.signature(pretorched_tpu_torch.MODEL_REGISTRY[name])
            want = inspect.signature(pretorched_tpu.MODEL_REGISTRY[name])
            assert ([(p.name, p.default) for p in sig.parameters.values()]
                    == [(p.name, p.default)
                        for p in want.parameters.values()]), name
