"""The port's non-local block and non-local ResNets against the JAX package's.

Weights are carried across with ``state_dict_from_flax`` after every BN of
the JAX model is randomized, so the blocks' zero-initialized output BN does
not hide the attention. Inputs have T != H != W, so a wrong flatten order
fails.
"""

import jax
import numpy as np
import pytest
import torch

from pretorched_tpu.models.nonlocalnet import NonLocalBlock as JaxNonLocalBlock
from pretorched_tpu_torch.models.nonlocalnet import NonLocalBlock

from torch_port_helpers import (carry_model, port_state_dict, randomize_bn,
                                to_nt, to_numpy_tree)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

MODES = ['embedded_gaussian', 'gaussian', 'dot_product', 'concatenation']


@pytest.mark.parametrize('sub_sample', [False, True])
@pytest.mark.parametrize('mode', MODES)
def test_block_matches_jax(mode, sub_sample):
    c = 16
    x = np.random.RandomState(0).randn(2, c, 4, 6, 8).astype(np.float32)
    jm = JaxNonLocalBlock(in_channels=c, dimension=3, mode=mode,
                          sub_sample=sub_sample)
    variables = randomize_bn(jm.init(jax.random.key(0), to_nt(x)))
    want = np.moveaxis(np.asarray(jm.apply(variables, to_nt(x))), -1, 1)

    block = NonLocalBlock(c, dimension=3, mode=mode,
                          sub_sample=sub_sample).eval()
    block.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('dimension,bn_layer', [(2, True), (3, False)])
def test_block_dimension_and_plain_output_conv(dimension, bn_layer):
    """A 2D block, and a block whose output is a zero-initialized conv with
    no BN (``W`` instead of ``W.0``/``W.1``), made non-zero here."""
    c = 8
    shape = (2, c, 6, 10) if dimension == 2 else (2, c, 4, 6, 8)
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype(np.float32)
    jm = JaxNonLocalBlock(in_channels=c, dimension=dimension,
                          bn_layer=bn_layer)
    variables = jm.init(jax.random.key(0), to_nt(x))
    if bn_layer:
        variables = randomize_bn(variables)
    else:
        variables = to_numpy_tree(variables)
        kernel = variables['params']['W']['kernel']
        variables['params']['W']['kernel'] = rng.uniform(
            -0.5, 0.5, kernel.shape).astype(np.float32)
    want = np.moveaxis(np.asarray(jm.apply(variables, to_nt(x))), -1, 1)
    block = NonLocalBlock(c, dimension=dimension, bn_layer=bn_layer).eval()
    block.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert np.abs(got - x).max() > 1e-2          # the block is not identity
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_nonlocalresnet3d18_matches_jax():
    """Two blocks engage in layer2 (N = 2 x 8 x 8)."""
    x = np.random.RandomState(1).randn(1, 3, 8, 64, 64).astype(np.float32)
    _, model, want = carry_model('nonlocalresnet3d18', x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_nonlocalresnet3d50_matches_jax_and_attention_matters():
    """Full depth, five blocks; then zeroing every ``W.1`` scale (the
    fresh-block state) must move the logits by more than the tolerance."""
    x = np.random.RandomState(2).randn(1, 3, 8, 32, 32).astype(np.float32)
    _, model, want = carry_model('nonlocalresnet3d50', x)
    blocks = [m for m in model.modules() if isinstance(m, NonLocalBlock)]
    assert len(blocks) == 5
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
        for blk in blocks:
            blk.W[1].weight.zero_()
        zeroed = model(torch.from_numpy(x)).numpy()
    assert np.abs(zeroed - got).max() > 10 * 2e-3


def test_mnist_nonlocal_net_matches_jax():
    """The tutorial net: two 2D non-local blocks (attention at N = 196,
    C = 16 and N = 49, C = 32), ``fc1`` on the (H, W, C)-ordered flatten;
    f32 at 1e-4, the attention's tolerance. Zeroing a block's ``W.1`` moves
    the logits, so the attention reaches them."""
    from pretorched_tpu.models.nonlocalnet import \
        MNISTNonLocalNet as JaxMNISTNonLocalNet
    from pretorched_tpu_torch.models.nonlocalnet import MNISTNonLocalNet

    rng = np.random.RandomState(5)
    x = rng.randn(3, 1, 28, 28).astype(np.float32)
    jm = JaxMNISTNonLocalNet()
    variables = randomize_bn(jax.jit(jm.init)(jax.random.key(0), to_nt(x)))
    for name in ('conv0', 'conv1', 'conv2', 'fc1'):
        b = variables['params'][name]['bias']
        variables['params'][name]['bias'] = rng.uniform(
            -0.2, 0.2, b.shape).astype(np.float32)
    want = np.asarray(jm.apply(variables, to_nt(x)))
    model = MNISTNonLocalNet().eval()
    model.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        assert got.shape == (3, 10)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        for block in (model.nonlocal1, model.nonlocal2):
            scale = block.W[1].weight.clone()
            block.W[1].weight.zero_()
            moved = (model(torch.from_numpy(x)) - got).norm() / got.norm()
            block.W[1].weight.copy_(scale)
            assert moved > 1e-3, moved
