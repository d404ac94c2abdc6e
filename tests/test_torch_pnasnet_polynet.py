"""The port's PNASNet-5-Large and PolyNet against the JAX package's, on
the CPU.

Each net carries the port's seeded weights (every BN randomized) into the
JAX module through the JAX converter on a ``jax.eval_shape`` template, and
is held in two pieces (``features_and_head``): ``features`` at full depth
and width of a 139 px image, which takes 331 px's odd / even steps
(PNASNet: 165, 83, 42, 21, 11 against 69, 35, 18, 9, 5; at 99 px JAX's
own cells fail on mismatched shapes), and ``logits`` of a seeded map of
the head pool's size (11x11, 9x9), at 2e-3 (whole nets). The poly-3 and
2-way modules at 2e-4 (blocks), on a seeded map: one conv shared by the
three applications, a BN each. PNASNet's 1001-class hosted file loses its
background row on an ``imagenet`` load, as the JAX converter drops it.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import pretorched_tpu_torch
from pretorched_tpu.models.pnasnet import PNASNet5Large
from pretorched_tpu.models.polynet import PolyNet
from pretorched_tpu_torch.models.polynet import MultiWay, block_b, poly_b, poly_c

from test_torch_inception_family import check_background_row
from torch_port_helpers import (assert_metadata_like_jax, assert_near,
                                features_and_head, port_state_dict,
                                randomize_bn, run_jax, to_numpy_tree, to_nt)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize('name,jax_cls,head', [
    ('pnasnet5large', PNASNet5Large, 11), ('polynet', PolyNet, 9)],
    ids=['pnasnet5large', 'polynet'])
def test_features_and_head_match_jax(name, jax_cls, head):
    model = pretorched_tpu_torch.__dict__[name](num_classes=10,
                                                pretrained=None)
    assert_metadata_like_jax(model, name)
    (gf, wf), (gl, wl) = features_and_head(model, jax_cls(num_classes=10),
                                           139, head, 331)
    assert gf.shape == (1, model.num_features) + (
        (5, 5) if name == 'pnasnet5large' else (3, 3))
    assert_near(gf, wf, 2e-3)
    assert_near(gl, wl, 2e-3)


@pytest.mark.parametrize('kind', ['poly_b', 'poly_c', 'multiway_b'])
def test_poly_modules_match_jax(kind):
    """A poly-3 module (``_poly_b`` / ``_poly_c``) and a 2-way one on a
    seeded 5x5 map, every BN randomized, at 2e-4."""
    cin = 2048 if kind == 'poly_c' else 1152
    x = np.random.RandomState(5).randn(2, cin, 5, 5).astype(np.float32)

    class One(PolyNet):
        @fnn.compact
        def __call__(self, x, train=False):
            if kind == 'multiway_b':
                return self._multiway(x, self._block_b, 0.9, 'm', train)
            return getattr(self, f'_{kind}')(x, 0.9, 'm', train)

    jmod = One()
    variables = randomize_bn(to_numpy_tree(jax.jit(jmod.init)(
        jax.random.key(0), to_nt(x[:1]))), seed=6)
    want = np.moveaxis(np.asarray(run_jax(jmod.apply, variables, to_nt(x))),
                       -1, 1)
    module = {'poly_b': lambda: poly_b(0.9), 'poly_c': lambda: poly_c(0.9),
              'multiway_b': lambda: MultiWay(block_b, 0.9)}[kind]().eval()
    module.load_state_dict({k[2:]: v for k, v in
                            port_state_dict(variables).items()}, strict=True)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    assert_near(got, want, 2e-4)
    if kind != 'multiway_b':
        # one conv a path, a BN for each of the three applications
        assert len(module.path0_1x1.bn_blocks) == 3
        assert sum(k.endswith('.conv.weight')
                   for k in module.state_dict()) == 4 + 3


def test_background_row_dropped_like_jax(tmp_path, monkeypatch):
    check_background_row('pnasnet5large', PNASNet5Large, 11, tmp_path,
                         monkeypatch)
