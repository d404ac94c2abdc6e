"""The port's Temporal Relation Networks (``pretorched_tpu_torch/models/
trn.py``) against the JAX package's, on the CPU.

``TRN`` with each consensus (``TRN``, ``HTRN``, ``MSTRN``, ``MSHTRN``)
over a narrow 2D ResNet backbone, built in both packages from the same
numpy-seeded weights (every BN of the JAX model randomized, carried across
strict), on 4-segment 32 px videos in f32 at 2e-3: the deterministic path
(MSTRN's first combinations). The ``trn`` factory over ``resnet18`` the
same way. MSTRN with a ``torch.Generator`` draws distinct combinations,
the same ones from the same seed; ``bfloat16()`` reaches the backbone's
convs. And the full-depth ``resnext3d101`` through ``carry_model``.
"""

import jax
import numpy as np
import pytest
import torch

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.models.resnet import ResNet as JaxResNet
from pretorched_tpu.models.trn import TRN as JaxTRN
from pretorched_tpu.models.trn import \
    pretrained_settings as jax_trn_settings
from pretorched_tpu_torch.models.resnet import ResNet
from pretorched_tpu_torch.models.trn import TRN, MultiScaleRelation
from pretorched_tpu_torch.models.trn import \
    pretrained_settings as trn_settings

from torch_port_helpers import (carry_model, port_state_dict, randomize_bn,
                                to_nt)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

SEGMENTS = 4
BACKBONE = dict(block='basic', layers=(1, 1, 1, 1),
                width_per_stage=(8, 8, 16, 16), num_classes=5)
HEAD = dict(frame_feature_dim=16, num_classes=7, num_segments=SEGMENTS,
            video_feature_dim=24, frame_bottleneck_dim=32)


def _videos(n=2, seed=0):
    return np.random.RandomState(seed).randn(n, 3, SEGMENTS, 32, 32).astype(
        np.float32)


def _randomize_biases(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomize_biases(v, rng)
        elif k == 'bias':
            tree[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)


@pytest.mark.parametrize('consensus', ['TRN', 'HTRN', 'MSTRN', 'MSHTRN'])
def test_trn_matches_jax(consensus):
    x = _videos()
    jmod = JaxTRN(base_module=JaxResNet(**BACKBONE), consensus=consensus,
                  **HEAD)
    variables = randomize_bn(jax.jit(jmod.init)(jax.random.key(0),
                                                to_nt(x[:1])), seed=1)
    _randomize_biases(variables['params'], np.random.RandomState(2))
    want = np.asarray(jmod.apply(variables, to_nt(x)))
    model = TRN(ResNet(**BACKBONE), consensus=consensus, **HEAD).eval()
    model.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 7)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_trn_factory_matches_jax():
    """``trn(arch='resnet18')``: the JAX factory grafts the backbone's whole
    variable tree, its unused head included (TRN calls the backbone with
    head=False); the port drops that head, so it is left out of the carry.
    Metadata comes from the backbone when TRN has no settings."""
    x = _videos(seed=3)
    kw = dict(num_classes=7, num_segments=SEGMENTS, arch='resnet18')
    jmodel = pretorched_tpu.trn(**kw)
    variables = randomize_bn(jmodel.variables, seed=4)
    jmodel.variables = variables
    want = np.asarray(jmodel(x))
    del variables['params']['base_module']['last_linear']
    model = pretorched_tpu_torch.trn(**kw).eval()
    model.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert model.settings is None and model.input_ndim == jmodel.input_ndim
    for attr in ('input_space', 'input_size', 'input_range', 'mean', 'std'):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert not any(k.startswith('base_module.last_linear')
                   for k in model.state_dict())
    assert trn_settings == jax_trn_settings
    assert 'trn' not in pretorched_tpu_torch.pretrained_settings
    with pytest.warns(UserWarning, match='not found locally'):
        moments = pretorched_tpu_torch.trn(pretrained='moments')
    assert moments.settings == jax_trn_settings['trn']['moments']
    assert moments.input_size == [3, 224, 224]


def test_mstrn_generator_draws_distinct_combinations():
    rel = MultiScaleRelation(8, 4, 6, bottleneck_dim=8)
    for scale in (7, 4, 2):
        first = rel.combinations(scale)
        assert first.shape == (3, scale)
        draws = [rel.combinations(scale, torch.Generator().manual_seed(s))
                 for s in (0, 0, 1)]
        assert torch.equal(draws[0], draws[1])
        for d in draws:
            assert d.shape == (3, scale)
            assert len({tuple(r) for r in d.tolist()}) == 3
            assert bool((d[:, 1:] > d[:, :-1]).all())   # ordered frames
    x = torch.randn(2, 1, 8, 4)
    with torch.no_grad():
        a = rel(x, torch.Generator().manual_seed(7))
        b = rel(x, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.shape == (2, 1, 6)


def test_bfloat16_reaches_the_backbone():
    model = TRN(ResNet(**BACKBONE), consensus='MSTRN', **HEAD).eval()
    seen = []
    model.base_module.conv1.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    model.bfloat16()
    assert model.base_module.compute_dtype == torch.bfloat16
    with torch.no_grad():
        out = model(torch.from_numpy(_videos()))
    assert seen == [torch.bfloat16] and out.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    model.float()
    assert model.base_module.compute_dtype is None


def test_resnext3d101_matches_jax():
    """The file's full-depth factory: grouped kernels carried across
    (DHW (I/groups) O -> O (I/groups) DHW) and loaded strict."""
    x = np.random.RandomState(6).randn(1, 3, 8, 32, 32).astype(np.float32)
    _, model, want = carry_model('resnext3d101', x)
    assert model.layer3[0].conv2.weight.shape == (512, 16, 3, 3, 3)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
