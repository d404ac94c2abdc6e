"""The port's space-to-depth stem fold (``pretorched_tpu_torch/ops/
space_to_depth.py``, ``layers.SpaceToDepthConv``) against the JAX package's,
on the CPU.

Each fold function takes the same numpy-seeded input as its JAX twin: the
port works channels-first on OI[T]HW weights, so its output must equal the
JAX one after ``moveaxis(1, -1)`` (activations) or the kernel transpose
(weights), at atol 1e-6 (f32, pure re-indexing). ``SpaceToDepthConv`` must
equal the plain strided conv on the same weight at rtol / atol 1e-4 (the
sums run in another order), as ``tests/test_space_to_depth.py`` holds the
JAX module, and the JAX module on carried weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pretorched_tpu.models.layers import SpaceToDepthConv as JaxS2DConv
from pretorched_tpu.ops import space_to_depth as jsd
from pretorched_tpu_torch.models.layers import (SpaceToDepthConv,
                                                init_parameters)
from pretorched_tpu_torch.ops import space_to_depth as psd

from torch_port_helpers import port_state_dict, to_numpy_tree
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _to_torch_kernel(k):
    """[T]HWIO -> OI[T]HW."""
    return np.ascontiguousarray(np.transpose(
        k, (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2))))


def _act(fn_port, fn_jax, shape):
    """(port output, JAX output moved to channels-first) on one input:
    channels-first for the port, channels-last for JAX."""
    x = _x(shape)
    got = fn_port(torch.from_numpy(x)).numpy()
    want = np.moveaxis(np.asarray(fn_jax(jnp.asarray(np.moveaxis(x, 1, -1)))),
                       -1, 1)
    return got, want


def _kernel(fn_port, fn_jax, torch_shape):
    w = _x(torch_shape, seed=1)
    jk = np.transpose(w, tuple(range(2, w.ndim)) + (1, 0))   # OI.. -> ..IO
    got = fn_port(torch.from_numpy(w)).numpy()
    return got, _to_torch_kernel(np.asarray(fn_jax(jnp.asarray(jk))))


def _parity_map(shape, jax_reshape):
    """A parity-folded map in both layouts: the port's (N, P*O, T, Hc, Wc)
    and the JAX one (N, T, Hc, Wc, *parities, O)."""
    y = _x(shape, seed=2)
    n, c, t, h, w = shape
    return y, np.moveaxis(y, 1, -1).reshape((n, t, h, w) + jax_reshape)


CASES = {
    'space_to_depth_2d 2D': lambda: _act(psd.space_to_depth_2d,
                                         jsd.space_to_depth_2d, (2, 3, 10, 12)),
    'space_to_depth_2d 3D': lambda: _act(psd.space_to_depth_2d,
                                         jsd.space_to_depth_2d,
                                         (2, 3, 4, 10, 12)),
    'space_to_depth_2d pads 3, 1': lambda: _act(
        lambda x: psd.space_to_depth_2d(x, 3, 1),
        lambda x: jsd.space_to_depth_2d(x, 3, 1), (1, 2, 3, 8, 6)),
    'fold_stem_kernel_2d': lambda: _kernel(psd.fold_stem_kernel_2d,
                                           jsd.fold_stem_kernel_2d,
                                           (8, 3, 7, 7)),
    'fold_stem_kernel_3d': lambda: _kernel(psd.fold_stem_kernel_3d,
                                           jsd.fold_stem_kernel_3d,
                                           (8, 3, 5, 7, 7)),
    'fold_stem_kernel_3d k5': lambda: _kernel(psd.fold_stem_kernel_3d,
                                              jsd.fold_stem_kernel_3d,
                                              (4, 2, 1, 5, 5)),
    'space_to_depth_4': lambda: _act(psd.space_to_depth_4,
                                     jsd.space_to_depth_4, (2, 3, 3, 12, 16)),
    'fold4_stem_kernel_3d': lambda: _kernel(psd.fold4_stem_kernel_3d,
                                            jsd.fold4_stem_kernel_3d,
                                            (8, 3, 5, 7, 7)),
    'space_to_depth_2x4': lambda: _act(psd.space_to_depth_2x4,
                                       jsd.space_to_depth_2x4,
                                       (2, 3, 3, 10, 12)),
    'fold2x4_stem_kernel_3d': lambda: _kernel(psd.fold2x4_stem_kernel_3d,
                                              jsd.fold2x4_stem_kernel_3d,
                                              (8, 3, 7, 7, 7)),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_fold_functions_match_jax(case):
    got, want = CASES[case]()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('fn', ['depth_to_space_2', 'depth_to_space_w2',
                                'folded_max_pool_3s2'])
def test_unfold_functions_match_jax(fn):
    parities = (2,) if fn == 'depth_to_space_w2' else (2, 2)
    y, jy = _parity_map((2, 8 * 2 ** len(parities), 3, 5, 6), parities + (8,))
    got = getattr(psd, fn)(torch.from_numpy(y)).numpy()
    want = np.moveaxis(np.asarray(getattr(jsd, fn)(jnp.asarray(jy))), -1, 1)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _strided(x, weight, ndim):
    ks = weight.shape[2:]
    pad = tuple(k // 2 for k in ks)
    if ndim == 3:
        return F.conv3d(x, weight, stride=(1, 2, 2), padding=pad)
    return F.conv2d(x, weight, stride=2, padding=pad)


# (kernel, ndim, fold, input shape): fold 2 in 2D and 3D, the SlowFast stems
# (1, 7, 7) and (5, 7, 7), fold 4 and its fold-2 fallback (H % 4 != 0), the
# plain conv on odd sizes
CONV_CASES = {
    '2d fold2': (7, 2, 2, (2, 3, 64, 64)),
    '2d odd sizes': (7, 2, 2, (1, 3, 63, 65)),
    '3d fold2': (7, 3, 2, (1, 3, 8, 32, 32)),
    '3d (1,7,7) fold2': ((1, 7, 7), 3, 2, (2, 3, 4, 32, 32)),
    '3d (5,7,7) fold4': ((5, 7, 7), 3, 4, (1, 3, 6, 32, 32)),
    '3d (5,7,7) fold4 falls back to fold2': ((5, 7, 7), 3, 4, (1, 3, 6, 30, 30)),
    '3d odd sizes': (7, 3, 2, (1, 3, 4, 33, 31)),
    '3d k5': (5, 3, 2, (1, 3, 4, 16, 16)),
}


@pytest.mark.parametrize('case', sorted(CONV_CASES))
def test_space_to_depth_conv_equals_strided_conv(case):
    kernel, ndim, fold, shape = CONV_CASES[case]
    mod = SpaceToDepthConv(3, 8, kernel, ndim=ndim, fold=fold)
    init_parameters(mod, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(shape))
    with torch.no_grad():
        got = mod(x)
        want = _strided(x, mod.weight, ndim)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('case', ['3d (5,7,7) fold4', '2d fold2',
                                  '3d odd sizes'])
def test_space_to_depth_conv_matches_jax(case):
    """The JAX module's kernel carried across (``conv1.weight``, strict):
    the same outputs on the same input."""
    kernel, ndim, fold, shape = CONV_CASES[case]
    x = _x(shape, seed=3)
    xt = np.moveaxis(x, 1, -1)
    jmod = JaxS2DConv(8, kernel, ndim=ndim, fold=fold)
    variables = to_numpy_tree(jax.jit(jmod.init)(jax.random.key(0), xt))
    want = np.moveaxis(np.asarray(jmod.apply(variables, xt)), -1, 1)
    mod = SpaceToDepthConv(3, 8, kernel, ndim=ndim, fold=fold)
    mod.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_space_to_depth_conv_under_autocast():
    """Under autocast the input is folded in the autocast dtype and the
    result is the bf16 strided conv's, within bf16 rounding."""
    mod = SpaceToDepthConv(3, 8, 7, ndim=2)
    init_parameters(mod, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((1, 3, 32, 32)))
    with torch.no_grad(), torch.autocast('cpu', dtype=torch.bfloat16):
        got = mod(x)
    assert got.dtype == torch.bfloat16
    with torch.no_grad():
        want = _strided(x, mod.weight, 2)
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err < 2e-2, err


def test_space_to_depth_conv_rejects_what_it_cannot_fold():
    with pytest.raises(ValueError, match='square odd'):
        SpaceToDepthConv(3, 8, (7, 6, 6))
    with pytest.raises(ValueError, match='fold'):
        SpaceToDepthConv(3, 8, 7, fold=3)
    with pytest.raises(ValueError, match='7x7'):
        psd.fold4_stem_kernel_3d(torch.zeros(8, 3, 5, 5, 5))
    with pytest.raises(ValueError, match='% 4'):
        psd.space_to_depth_4(torch.zeros(1, 3, 2, 30, 32))


def test_wideresnet3d50_matches_jax_and_folds_its_stem():
    """The file's full-depth factory (widths x 2, expansion 2) against the
    JAX model, and the same weights with the stem folded (``s2d_stem``)."""
    from pretorched_tpu_torch.models.resnet3d import VideoResNet

    from torch_port_helpers import carry_model

    x = _x((1, 3, 8, 32, 32), seed=7)
    _, model, want = carry_model('wideresnet3d50', x)
    folded = VideoResNet('bottleneck', (3, 4, 6, 3), num_classes=10,
                         expansion=2, width_per_stage=(128, 256, 512, 1024),
                         s2d_stem=True).eval()
    folded.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        got_folded = folded(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got_folded, got, rtol=2e-5, atol=2e-5)
