"""The port's DPN (all six configurations), MobileNetV2, VGG-M and its
cross-map LRN against the JAX package's, on the CPU.

Each net carries the port's seeded weights (every BN randomized) into the
JAX module through the JAX converter on a ``jax.eval_shape`` template. DPN
is held in two pieces (``features_and_head``): ``features`` at full depth
and width of a 64 px image, and the ``test_time_pool`` eval head on a
seeded 9x9 map (its 7x7/1 pool leaves 3x3 for the avg-max pool).
``dpn68b``'s train-mode head (global average pool, then the classifier
conv) against JAX's, and against the eval head, which it equals on a
7x7 map only; one train-mode forward at 64 px (DPN has no dropout) with
every BN's running statistics after it. MobileNetV2 whole
at 64 px, VGG-M whole at 221 px (its 18,432-wide ``classif``). Whole nets
at 2e-3, LRN against ``pretorched_tpu.ops.lrn`` at 1e-4.
"""

import numpy as np
import pytest
import torch

import pretorched_tpu_torch
from pretorched_tpu.models.dpn import _CONFIGS, DPN
from pretorched_tpu.models.mobilenet import MobileNetV2
from pretorched_tpu.models.vggm import VGGM
from pretorched_tpu.ops.lrn import spatial_cross_map_lrn as jax_lrn
from pretorched_tpu_torch.ops.lrn import spatial_cross_map_lrn

from torch_port_helpers import (assert_metadata_like_jax, assert_near,
                                features_and_head, jax_variables_from_port,
                                port_state_dict, randomize_port_bn, run_jax,
                                to_nt)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize('shape,size,alpha,beta,k', [
    ((2, 16, 7, 7), 5, 0.0005, 0.75, 2.0),      # VGG-M's
    ((1, 9, 5, 6), 4, 1e-4, 0.75, 1.0),         # an even window
    ((3, 3, 4, 4), 7, 1e-2, 0.5, 2.0)],         # wider than the channels
    ids=['vggm', 'even', 'wide'])
def test_lrn_matches_jax(shape, size, alpha, beta, k):
    x = 3 * np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.moveaxis(np.asarray(jax_lrn(to_nt(x), size, alpha, beta, k)),
                       -1, 1)
    got = spatial_cross_map_lrn(torch.from_numpy(x), size, alpha, beta, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert spatial_cross_map_lrn(torch.from_numpy(x).bfloat16(), size,
                                 alpha, beta, k).dtype == torch.bfloat16


@pytest.mark.parametrize('name', sorted(_CONFIGS))
def test_dpn_matches_jax(name):
    model = pretorched_tpu_torch.__dict__[name](num_classes=10,
                                                pretrained=None)
    assert_metadata_like_jax(model, name)
    assert model.last_linear is None and model.test_time_pool
    (gf, wf), (gl, wl) = features_and_head(
        model, DPN(num_classes=10, test_time_pool=True, **_CONFIGS[name]),
        64, 9, 224)
    assert gf.shape == (1, model.num_features, 2, 2)
    assert_near(gf, wf, 2e-3)
    assert_near(gl, wl, 2e-3)
    with pytest.raises(ValueError, match='no linear head'):
        model.reset_classifier(5)


def test_dpn68b_train_mode_matches_jax():
    """The train-mode head (global average pool, then the classifier conv)
    and the ``test_time_pool`` eval head each against JAX's on seeded maps:
    they differ on a 9x9 map and agree on a 7x7 one (conv(mean) ==
    mean(conv)). Then one train-mode forward at 64 px (DPN has no
    dropout) and every BN's running statistics after it."""
    model = randomize_port_bn(pretorched_tpu_torch.dpn68b(
        num_classes=10, pretrained=None))
    jmodule = DPN(num_classes=10, test_time_pool=True, **_CONFIGS['dpn68b'])
    variables = jax_variables_from_port(jmodule, model.state_dict(),
                                        (1, 224, 224, 3))
    rng = np.random.RandomState(2)
    with torch.no_grad():
        for hw in (9, 7):
            fmap = rng.randn(2, model.num_features, hw, hw).astype(np.float32)
            heads = {}
            for train in (True, False):
                want = np.asarray(jmodule.apply(variables, to_nt(fmap),
                                                mode='logits', train=train))
                heads[train] = model.train(train).logits(
                    torch.from_numpy(fmap)).numpy()
                assert_near(heads[train], want, 2e-3)
            assert (np.abs(heads[True] - heads[False]).max() < 1e-5) == (
                hw == 7)
    x = np.random.RandomState(3).randn(2, 3, 64, 64).astype(np.float32)
    want, updates = run_jax(lambda v, x: jmodule.apply(
        v, x, train=True, mutable=['batch_stats']), variables, to_nt(x))
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x)).numpy()
    assert_near(got, np.asarray(want), 2e-3)
    want_sd = port_state_dict({'params': variables['params'],
                               'batch_stats': updates['batch_stats']})
    got_sd = model.state_dict()
    stats = [k for k in want_sd if k.endswith(('running_mean', 'running_var'))]
    # the stem's and the last BN, 3 a block and the 4 projections'
    assert len(stats) == 2 * (2 + 3 * sum(_CONFIGS['dpn68b']['k_sec']) + 4)
    for key in stats:
        assert_near(got_sd[key].numpy(), want_sd[key].numpy(), 2e-3)


@pytest.mark.parametrize('name,jax_cls,size', [
    ('mobilenetv2', MobileNetV2, 64), ('vggm', VGGM, 221)],
    ids=['mobilenetv2', 'vggm'])
def test_whole_net_matches_jax(name, jax_cls, size):
    model = randomize_port_bn(pretorched_tpu_torch.__dict__[name](
        num_classes=10, pretrained=None)).eval()
    assert_metadata_like_jax(model, name)
    x = np.random.RandomState(0).randn(2, 3, size, size).astype(np.float32)
    if name == 'vggm':
        x = 50 * x      # the BGR [0, 255] range, less its mean
    jmodule = jax_cls(num_classes=10)
    variables = jax_variables_from_port(jmodule, model.state_dict(),
                                        (1, size, size, 3))
    with torch.no_grad():
        assert_near(model(torch.from_numpy(x)).numpy(),
                    np.asarray(run_jax(jmodule.apply, variables, to_nt(x))),
                    2e-3)
        feats = model.features(torch.from_numpy(x)).numpy()
    assert_near(feats, np.moveaxis(np.asarray(run_jax(
        lambda v, x: jmodule.apply(v, x, mode='features'), variables,
        to_nt(x))), -1, 1), 2e-3)
    if name == 'vggm':
        assert feats.shape == (2, 512, 6, 6)
        assert model.classif[0].in_features == 18432
