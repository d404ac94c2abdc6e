"""The port's NASNet-A (``pretorched_tpu_torch/models/nasnet.py``) against
the JAX package's, on the CPU.

The TF padding helpers (``max_pool_pad``, ``avg_pool_pad``, ``_avg31``)
at 1e-6; each cell kind (both stems, the first and the normal cell, the
reduction cells in their three paddings) on odd spatial sizes, at 2e-4
(blocks); full ``nasnetamobile`` at 224 px and ``nasnetalarge``'s widths
with one normal cell a stage at 331 px, at 2e-3 (whole nets). The full nets
carry the port's seeded weights (every BN randomized) into JAX through the
JAX converter, on a template from ``jax.eval_shape``, so JAX compiles only
the forward. The background row of ``nasnetalarge``'s 1001-class
checkpoint is dropped on an ``imagenet`` load, as the JAX converter drops
it, and kept for ``imagenet+background``.
"""

import warnings

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.models import nasnet as jnas
from pretorched_tpu_torch.models import nasnet

from torch_port_helpers import (jax_variables_from_port, port_state_dict,
                                randomize_bn, randomize_port_bn,
                                to_numpy_tree, to_nt)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _nchw(x):
    return np.moveaxis(np.asarray(x), -1, 1)


@pytest.mark.parametrize('fn', ['max_pool_pad', 'avg_pool_pad', '_avg31'])
@pytest.mark.parametrize('size', [15, 16])
def test_padding_helpers_match_jax(fn, size):
    x = np.random.RandomState(0).randn(2, 8, size, size).astype(np.float32)
    want = _nchw(getattr(jnas, fn)(to_nt(x)))
    got = getattr(nasnet, fn)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# (JAX method, its arguments after the inputs, the port's cell, the input
# shapes): stem_filters 16, filters 8, odd spatial sizes (the top-left pads
# and crops and the shifted path all matter). Stem 1 takes conv0's output
# and stem 0's; the other cells the current state (24 channels) and the
# previous one (16); the first cell's previous state has twice its size.
CUR, PREV, HALF = (2, 24, 17, 17), (2, 16, 17, 17), (2, 24, 9, 9)
CELLS = {
    'stem_0': ('_cell_stem_0', (8,), lambda: nasnet.CellStem0(16, 8),
               (PREV,)),
    'stem_1': ('_cell_stem_1', (8,),
               lambda: nasnet.CellStem1(16, 24, 8, False), (PREV, HALF)),
    'stem_1_specific': ('_cell_stem_1', (8,),
                        lambda: nasnet.CellStem1(16, 24, 8, True),
                        (PREV, HALF)),
    'first': ('_first_cell', (4, 8, 'c'),
              lambda: nasnet.NormalCell(24, 16, 4, 8, first=True),
              (HALF, PREV)),
    'normal': ('_normal_cell', (8, 8, 'c'),
               lambda: nasnet.NormalCell(24, 16, 8, 8, first=False),
               (CUR, PREV)),
    'reduction_0': ('_reduction_cell', (8, 8, 'c'),
                    lambda: nasnet.ReductionCell(24, 16, 8, 8, True, False),
                    (CUR, PREV)),
    'reduction_1': ('_reduction_cell', (8, 8, 'c'),
                    lambda: nasnet.ReductionCell(24, 16, 8, 8, False, False),
                    (CUR, PREV)),
    'reduction_1_specific': ('_reduction_cell', (8, 8, 'c'),
                             lambda: nasnet.ReductionCell(24, 16, 8, 8,
                                                          False, True),
                             (CUR, PREV)),
}


@pytest.mark.parametrize('kind', sorted(CELLS))
def test_cells_match_jax(kind):
    method, extra, make, shapes = CELLS[kind]
    rng = np.random.RandomState(1)
    xs = [rng.randn(*shape).astype(np.float32) for shape in shapes]
    kw = ({'reduction_style': kind == 'reduction_0'}
          if method == '_reduction_cell' else {})

    class One(jnas.NASNetA):
        @fnn.compact
        def __call__(self, *inputs, train=False):
            return getattr(self, method)(*inputs, *extra, train, **kw)

    jmod = One(specific_stem1=kind.endswith('specific'))
    nt = [to_nt(x) for x in xs]
    # eager: at these sizes dispatching each op costs less than a compile
    variables = randomize_bn(to_numpy_tree(jmod.init(jax.random.key(0),
                                                     *nt)), seed=2)
    want = _nchw(jmod.apply(variables, *nt))
    cell = make().eval()
    # the JAX names carry the cell's prefix ('c.' or 'cell_stem_0.')
    cell.load_state_dict({k.split('.', 1)[1]: v for k, v in
                          port_state_dict(variables).items()}, strict=True)
    with torch.no_grad():
        got = cell(*[torch.from_numpy(x) for x in xs]).numpy()
    assert got.shape == want.shape and got.shape[1] == cell.out_channels
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _port_vs_jax(model, jmodule, size, batch=1, seed=0, **convert_kw):
    """The port's logits and the JAX module's on the same weights."""
    randomize_port_bn(model, seed=seed).eval()
    x = np.random.RandomState(seed).randn(batch, 3, size, size).astype(
        np.float32)
    variables = jax_variables_from_port(jmodule, model.state_dict(),
                                        (1, size, size, 3), **convert_kw)
    want = np.asarray(jax.jit(jmodule.apply)(variables, to_nt(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    return got, want


def test_nasnetamobile_matches_jax():
    model = pretorched_tpu_torch.nasnetamobile(num_classes=1000,
                                               pretrained=None)
    jmodule = jnas.NASNetA(num_classes=1000, stem_filters=32,
                           penultimate_filters=1056, num_normal_cells=4,
                           specific_stem1=True, head_pool=7)
    got, want = _port_vs_jax(model, jmodule, 224, seed=1)
    assert got.shape == (1, 1000)
    assert sum(p.numel() for p in model.parameters()) == 5289978
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_nasnetalarge_reduced_cells_matches_jax():
    """Large's widths (stem 96, 4032 penultimate filters) and its
    second-to-last-cell wiring, one normal cell a stage, at 331 px."""
    kw = dict(num_classes=10, stem_filters=96, penultimate_filters=4032,
              num_normal_cells=1, specific_stem1=False, head_pool=11)
    got, want = _port_vs_jax(nasnet.NASNetA(**kw), jnas.NASNetA(**kw), 331,
                             seed=2)
    assert got.shape == (1, 10)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


SMALL_LARGE = dict(stem_filters=16, penultimate_filters=192,
                   num_normal_cells=1)


def test_background_class_dropped_like_jax(tmp_path, monkeypatch):
    """A 1001-class hosted checkpoint (Large's wiring at reduced widths)
    through ``nasnetalarge(pretrained='imagenet')``: its first row goes, as
    in the JAX converter's ``background_class_keys``; ``imagenet+background``
    keeps all 1001."""
    donor = randomize_port_bn(nasnet.NASNetA(
        num_classes=1001, specific_stem1=False, head_pool=11,
        **SMALL_LARGE), seed=3)
    sd = donor.state_dict()
    url = pretorched_tpu_torch.pretrained_settings['nasnetalarge'][
        'imagenet']['url']
    (tmp_path / 'weights').mkdir()
    torch.save(sd, tmp_path / 'weights' / url.rsplit('/', 1)[-1])
    monkeypatch.setenv('PRETORCHED_HOME', str(tmp_path))
    monkeypatch.setenv('PRETORCHED_STRICT_WEIGHTS', '1')
    small = nasnet.NASNetA
    monkeypatch.setattr(nasnet, 'NASNetA',
                        lambda **kw: small(**dict(kw, **SMALL_LARGE)))
    with warnings.catch_warnings():
        warnings.simplefilter('error')      # every key used: no warning
        model = pretorched_tpu_torch.nasnetalarge().eval()
        full = pretorched_tpu_torch.nasnetalarge(
            num_classes=1001, pretrained='imagenet+background').eval()
    assert model.input_size == [3, 331, 331] and model.mean == [0.5] * 3
    torch.testing.assert_close(model.last_linear.weight,
                               sd['last_linear.weight'][1:])
    torch.testing.assert_close(full.last_linear.bias, sd['last_linear.bias'])
    jmodule = jnas.NASNetA(num_classes=1000, specific_stem1=False,
                           head_pool=11, **SMALL_LARGE)
    variables = jax_variables_from_port(
        jmodule, sd, (1, 331, 331, 3), background_class_keys=('last_linear',))
    x = np.random.RandomState(4).randn(1, 3, 331, 331).astype(np.float32)
    want = np.asarray(jax.jit(jmodule.apply)(variables, to_nt(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_factories_match_jax():
    for name in ('nasnetalarge', 'nasnetamobile'):
        assert name in pretorched_tpu_torch.model_names
        assert (pretorched_tpu_torch.pretrained_settings[name]
                == pretorched_tpu.pretrained_settings[name])
    model = pretorched_tpu_torch.nasnetamobile(num_classes=1000,
                                               pretrained=None)
    assert model.input_ndim == 4 and model.input_size == [3, 224, 224]
    assert model.std == [0.5, 0.5, 0.5] and model.head_pool == 7


def test_train_step_dropout_draws_from_the_seeded_generator():
    """NASNet's head dropout (0.5) is on in train mode only, and draws from
    torch's global generator (its dropout takes no generator): the same
    ``torch.manual_seed`` repeats a ``make_train_step`` step exactly."""
    from pretorched_tpu_torch.parallel.train import (make_train_step,
                                                     sgd_step_decay)
    kw = dict(num_classes=5, stem_filters=8, penultimate_filters=96,
              num_normal_cells=1, specific_stem1=True, head_pool=1)
    x = torch.from_numpy(np.random.RandomState(5).randn(
        4, 3, 32, 32).astype(np.float32))
    labels = torch.tensor([0, 1, 2, 3])
    init = randomize_port_bn(nasnet.NASNetA(**kw), seed=5).state_dict()

    def step(seed):
        model = nasnet.NASNetA(**kw)
        model.load_state_dict(init)
        opt, sched = sgd_step_decay(model.parameters(), lr=0.1)
        torch.manual_seed(seed)
        loss = float(make_train_step(model, opt, sched)(x, labels)['loss'])
        return loss, model.last_linear.weight.detach().clone()

    (a, wa), (b, wb), (c, _) = step(0), step(0), step(1)
    assert a == b and torch.equal(wa, wb) and a != c
    model = nasnet.NASNetA(**kw).eval()
    with torch.no_grad():
        torch.testing.assert_close(model(x), model(x), rtol=0, atol=0)
