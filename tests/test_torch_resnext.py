"""The port's ResNeXt (``pretorched_tpu_torch/models/resnext.py``) and its
positional loader (``zoo/convert.convert_state_dict_ordered``, wired into
``zoo/io.load_pretrained``) on the CPU.

A torch twin of the reference's Lambda graph (nested Sequential /
ConcatTable, auto-index keys; the builder of
``tests/test_resnext_lambda_graph.py``) at depth (1, 1, 1, 1), every BN
randomized, written as a hosted file and loaded through ``load_pretrained``
by position: the port's logits equal the twin's at 2e-3. The JAX ``ResNeXt``
at the same depth on carried weights (BN randomized), 32x4d and 64x4d:
logits at 2e-3, the whole-net tolerance of
``tests/test_full_network_parity.py``. A checkpoint with a module too few,
a shape that disagrees or a typo'd leaf is refused. The full-depth
factories' ``ordered_leaves`` cover every module that holds a parameter.
"""

import jax
import numpy as np
import pytest
import torch

import pretorched_tpu_torch
from pretorched_tpu.models.resnext import ResNeXt as JaxResNeXt
from pretorched_tpu_torch.models.resnext import ResNeXt, ordered_leaves
from pretorched_tpu_torch.zoo import io as zoo_io
from pretorched_tpu_torch.zoo.convert import (convert_state_dict_ordered,
                                              group_state_dict_in_order)

import torch_twins as twins
from test_resnext_lambda_graph import _lambda_graph_resnext
from torch_port_helpers import port_state_dict, randomize_bn, to_numpy_tree, to_nt
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

LAYERS = (1, 1, 1, 1)


def _x():
    return np.random.RandomState(0).randn(2, 3, 224, 224).astype(np.float32)


def test_lambda_graph_file_loads_by_position(tmp_path, monkeypatch):
    tm = _lambda_graph_resnext(LAYERS).eval()
    twins.randomize_bn(tm)
    sd = tm.state_dict()
    # the keys really are auto-indices
    assert any(k.startswith('features.4.0.0.0.0.') for k in sd), list(sd)[:8]
    (tmp_path / 'weights').mkdir()
    torch.save(sd, tmp_path / 'weights' / 'resnext_small.pth')
    monkeypatch.setenv('PRETORCHED_HOME', str(tmp_path))
    model = ResNeXt(layers=LAYERS, num_classes=10)
    missing, unexpected = zoo_io.load_pretrained(
        model, 'resnext_small', 'imagenet',
        {'url': 'http://host/resnext_small.pth'},
        ordered_leaves=ordered_leaves(LAYERS))
    assert missing == [] and unexpected == []
    x = _x()
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize('cardinality', [32, 64])
def test_logits_match_jax(cardinality):
    x = _x()
    jmod = JaxResNeXt(layers=LAYERS, cardinality=cardinality, num_classes=10)
    variables = randomize_bn(to_numpy_tree(
        jax.jit(jmod.init)(jax.random.key(0), to_nt(x[:1]))), seed=1)
    want = np.asarray(jax.jit(jmod.apply)(variables, to_nt(x)))
    model = ResNeXt(layers=LAYERS, cardinality=cardinality, num_classes=10)
    model.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
        feats = model.features(torch.from_numpy(x))
    assert feats.shape == (2, 2048, 7, 7)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_mismatched_checkpoint_is_refused():
    sd = _lambda_graph_resnext(LAYERS).state_dict()
    own = ResNeXt(layers=LAYERS, num_classes=10).state_dict()
    leaves = ordered_leaves(LAYERS)
    last = group_state_dict_in_order(sd)[-1][0]
    fewer = {k: v for k, v in sd.items() if not k.startswith(last + '.')}
    with pytest.raises(ValueError, match='leaf count mismatch'):
        convert_state_dict_ordered(fewer, own, leaves)
    wrong = dict(sd)
    wrong[last + '.weight'] = torch.zeros(10, 1024)
    with pytest.raises(ValueError, match='shape mismatch'):
        convert_state_dict_ordered(wrong, own, leaves)
    with pytest.raises(ValueError, match='matches no model variable'):
        convert_state_dict_ordered(sd, own, leaves[:-1] + ['last_linaer'])
    # the 64x4d model does not take a 32x4d file
    wide = ResNeXt(layers=LAYERS, cardinality=64, num_classes=10).state_dict()
    with pytest.raises(ValueError, match='shape mismatch'):
        convert_state_dict_ordered(sd, wide, leaves)


@pytest.mark.parametrize('name', ['resnext101_32x4d', 'resnext101_64x4d'])
def test_factories_order_every_leaf(name):
    model = pretorched_tpu_torch.__dict__[name](pretrained=None)
    groups = [p for p, _ in group_state_dict_in_order(model.state_dict())]
    assert sorted(groups) == sorted(ordered_leaves())
    assert model.input_size == [3, 224, 224] and name in \
        pretorched_tpu_torch.model_names
