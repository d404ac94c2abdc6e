"""The port's PIL oracle (``pretorched_tpu_torch/transforms/utils.py``)
against ``pretorched_tpu.transforms.utils`` on the repository's images, at
1e-6, and the device path's ``preserve_aspect_ratio=False`` resize against
the JAX package's ``fused_preprocess``."""

import os

import numpy as np
import pytest
import torch

from pretorched_tpu.transforms import fused as jax_fused
from pretorched_tpu.transforms import utils as jax_utils
from pretorched_tpu_torch.transforms import fused, utils

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'data')

RGB01 = {'input_size': [3, 224, 224], 'input_space': 'RGB',
         'input_range': [0, 1], 'mean': [0.485, 0.456, 0.406],
         'std': [0.229, 0.224, 0.225]}
BGR255 = {'input_size': [3, 299, 299], 'input_space': 'BGR',
          'input_range': [0, 255], 'mean': [104, 117, 128],
          'std': [1, 1, 1], 'scale': 0.9}


@pytest.mark.parametrize('image', ['cat.jpg', 'croco.jpg'])
@pytest.mark.parametrize('settings', [RGB01, BGR255], ids=['rgb01', 'bgr255'])
@pytest.mark.parametrize('preserve_aspect_ratio', [True, False])
def test_transform_image_matches_jax(image, settings, preserve_aspect_ratio):
    img = utils.LoadImage()(os.path.join(DATA, image))
    got = utils.TransformImage(
        settings, preserve_aspect_ratio=preserve_aspect_ratio)(img)
    want = jax_utils.TransformImage(
        settings, preserve_aspect_ratio=preserve_aspect_ratio)(img)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == tuple(settings['input_size'])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('image', ['cat.jpg', 'croco.jpg'])
@pytest.mark.parametrize('settings', [RGB01, BGR255], ids=['rgb01', 'bgr255'])
def test_load_transform_image_matches_jax(image, settings):
    path = os.path.join(DATA, image)
    got = utils.LoadTransformImage(settings)(path)
    want = jax_utils.LoadTransformImage(settings)(path)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_seeded_train_transform_matches_jax():
    """Random crop and flips drawn from the same seed land alike."""
    img = utils.LoadImage()(os.path.join(DATA, 'cat.jpg'))
    kw = dict(random_crop=True, random_hflip=True, random_vflip=True, seed=3)
    got = utils.TransformImage(RGB01, **kw)
    want = jax_utils.TransformImage(RGB01, **kw)
    for _ in range(3):
        np.testing.assert_allclose(got(img).numpy(), want(img), rtol=1e-6,
                                   atol=1e-6)


def test_compose_identity_and_small_transforms():
    t = torch.arange(6, dtype=torch.float32).reshape(3, 1, 2)
    chain = utils.Compose([utils.Identity(), utils.ToSpaceBGR(True),
                           utils.ToRange255(True)])
    want = jax_utils.Compose([jax_utils.Identity(), jax_utils.ToSpaceBGR(True),
                              jax_utils.ToRange255(True)])(t.numpy())
    np.testing.assert_array_equal(chain(t).numpy(), want)
    assert utils.ToSpaceBGR(False)(t) is t and utils.ToRange255(False)(t) is t


@pytest.mark.parametrize('hw', [(240, 320), (300, 200)])
@pytest.mark.parametrize('settings', [RGB01, BGR255], ids=['rgb01', 'bgr255'])
def test_fused_without_aspect_ratio_matches_jax(hw, settings):
    """``preserve_aspect_ratio=False`` resizes to input_size / scale, then
    center-crops. Held to an f64 evaluation of the same two resize matmuls
    at 1e-4 of a pixel, and to the JAX package at 1e-4 of the value range
    (1e-4 for normalized RGB, 0.0255 for BGR in [0, 255]): on the CPU,
    JAX's one three-operand einsum lands up to 8.3e-3 of a pixel from f64
    at these shapes, the port 2.9e-5."""
    raw = np.random.RandomState(0).randint(0, 256, (2,) + hw + (3,), np.uint8)
    want = np.asarray(jax_fused.fused_preprocess(
        raw, settings, preserve_aspect_ratio=False))
    got = fused.fused_preprocess(raw, settings, preserve_aspect_ratio=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * max(settings['input_range']))
    pixels = dict(settings, input_range=[0, 255], input_space='RGB',
                  mean=[0, 0, 0], std=[1, 1, 1])
    got = fused.fused_preprocess(raw, pixels, preserve_aspect_ratio=False,
                                 dtype=torch.float64)
    size, scale = settings['input_size'][1], settings.get('scale', 0.875)
    nh = nw = int(size / scale)
    top, left = round((nh - size) / 2.0), round((nw - size) / 2.0)
    wh = fused.resize_weights(hw[0], size, nh / hw[0], -float(top)).double()
    ww = fused.resize_weights(hw[1], size, nw / hw[1], -float(left)).double()
    exact = torch.einsum('oh,pw,bhwc->bopc', wh, ww,
                         torch.from_numpy(raw).double())
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=0, atol=1e-4)
