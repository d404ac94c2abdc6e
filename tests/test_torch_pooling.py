"""The port's pooling (``pretorched_tpu_torch/ops/pooling.py``, channels
first) against ``pretorched_tpu.ops.pooling`` (channels last) at 1e-6:
ceil mode with its dropped last window, explicit padding in and out of the
average's divisor, adaptive windows that do not divide the input, and the
DPN combined pools."""

import numpy as np
import pytest
import torch

from pretorched_tpu.ops import pooling as jp
from pretorched_tpu_torch.ops import pooling as tp


def _both(fn_jax, fn_port, shape, seed=0):
    """(port output, JAX output), both channels-first, on one input."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    want = np.moveaxis(np.asarray(fn_jax(np.moveaxis(x, 1, -1))), -1, 1)
    return fn_port(torch.from_numpy(x)).numpy(), want


# (input shape NC..., kernel, stride, padding, ceil_mode)
WINDOWS = [
    ((2, 3, 15, 15), 3, 2, 1, False),
    ((2, 3, 15, 15), 3, 2, 0, True),        # the last window kept
    ((2, 3, 14, 13), 3, 2, 1, True),
    ((2, 3, 5, 6), 2, 2, 1, True),          # H's last window starts in the
    #                                         padding: dropped (3 rows, 4 cols)
    ((1, 4, 10, 11), 2, 2, 0, True),
    ((1, 2, 9, 12), (3, 2), (2, 1), (1, 0), True),
    ((1, 2, 5, 9, 9), 3, 2, 1, True),       # 3D
    ((2, 3, 16), 3, 2, 1, True),            # 1D
]


@pytest.mark.parametrize('shape,k,s,p,ceil', WINDOWS)
def test_max_pool_matches_jax(shape, k, s, p, ceil):
    got, want = _both(lambda x: jp.max_pool(x, k, s, p, ceil),
                      lambda x: tp.max_pool(x, k, s, p, ceil), shape)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('count_include_pad', [True, False])
@pytest.mark.parametrize('shape,k,s,p,ceil', WINDOWS)
def test_avg_pool_matches_jax(shape, k, s, p, ceil, count_include_pad):
    got, want = _both(
        lambda x: jp.avg_pool(x, k, s, p, ceil, count_include_pad),
        lambda x: tp.avg_pool(x, k, s, p, ceil, count_include_pad), shape)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# (input shape, output size): windows that overlap and do not divide
ADAPTIVE = [
    ((2, 3, 7, 7), 3),
    ((2, 3, 5, 9), (2, 4)),
    ((1, 4, 10, 10), 1),
    ((1, 2, 4, 6, 7), (3, 2, 5)),           # 3D
]


@pytest.mark.parametrize('shape,out', ADAPTIVE)
@pytest.mark.parametrize('kind', ['avg', 'max'])
def test_adaptive_pools_match_jax(shape, out, kind):
    fj = jp.adaptive_avg_pool if kind == 'avg' else jp.adaptive_max_pool
    ft = tp.adaptive_avg_pool if kind == 'avg' else tp.adaptive_max_pool
    got, want = _both(lambda x: fj(x, out), lambda x: ft(x, out), shape)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('pool_type', ['avg', 'max', 'avgmax', 'avgmaxc'])
@pytest.mark.parametrize('out', [1, 3])
def test_adaptive_avgmax_pool2d_matches_jax(pool_type, out):
    got, want = _both(
        lambda x: jp.adaptive_avgmax_pool2d(x, pool_type, out),
        lambda x: tp.adaptive_avgmax_pool2d(x, pool_type, out), (2, 5, 7, 8))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('keepdims', [False, True])
@pytest.mark.parametrize('shape', [(2, 3, 5, 6), (2, 3, 2, 5, 6)])
def test_global_avg_pool_matches_jax(shape, keepdims):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = np.asarray(jp.global_avg_pool(np.moveaxis(x, 1, -1), keepdims))
    if keepdims:
        want = np.moveaxis(want, -1, 1)
    got = tp.global_avg_pool(torch.from_numpy(x), keepdims=keepdims).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
