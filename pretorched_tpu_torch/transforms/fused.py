"""Device-side eval preprocessing: resize -> crop -> BGR -> range -> normalize.

Counterpart of the eval chain of ``pretorched_tpu/transforms/fused.py``
(l.27-132, 215-222). The host only decodes JPEGs to uint8; the chain runs on
the tensor's device:

* the resize and the center crop are one pair of small matmuls, with the
  antialiased-triangle weights that ``jax.image.scale_and_translate`` builds
  (jax/_src/image/scale.py ``compute_weight_mat``), computed only for the
  crop window's output pixels. So the port matches the JAX package at f32
  tolerance, not merely at PIL tolerance;
* range scaling and mean/std fold into one FMA (``_affine_consts``);
* when the resize is the identity, the uint8 window is cropped first.

The train chain (``fused_train_preprocess``, l.141-198) draws its crop
offsets and flips from a ``torch.Generator`` and hands them to a
deterministic core, ``fused_train_apply``, which a test can feed the draws
of JAX's ``_fused_train``. ``ten_crop`` (l.201-213) is the 10-crop eval.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..utils.profiling import count, span


def _settings_tuple(settings) -> Tuple:
    get = settings.__getitem__ if isinstance(settings, dict) else \
        lambda k: getattr(settings, k)
    has = settings.__contains__ if isinstance(settings, dict) else \
        lambda k: hasattr(settings, k)
    return (tuple(get('input_size')), get('input_space'),
            tuple(get('input_range')), tuple(get('mean')), tuple(get('std')),
            get('scale') if has('scale') else 0.875)


def _resize_target(h, w, crop, scale, preserve_aspect_ratio, input_size):
    """Resized (nh, nw) before the center crop: the shorter side becomes
    floor(crop/scale), like torchvision ``Resize(int)``; without
    ``preserve_aspect_ratio``, (H, W) of ``input_size`` over ``scale``,
    like ``Resize((h, w))``."""
    if not preserve_aspect_ratio:
        return int(input_size[1] / scale), int(input_size[2] / scale)
    target_short = int(math.floor(crop / scale))
    if h <= w:
        return target_short, int(round(target_short * w / h))
    return int(round(target_short * h / w)), target_short


def _affine_consts(input_range, mean, std, dtype, device):
    """u8 -> [0,1] (or [0,255]) scaling and (x - mean) / std as one FMA:
    ``x * (k/std) + (-mean/std)``, constants computed in float64."""
    k = 1.0 if max(input_range) == 255 else 1.0 / 255.0
    std64 = np.asarray(std, np.float64)
    # two constants made on the host, each copied to ``device``
    count('preprocess.host_consts', 2)
    mul = torch.as_tensor(k / std64, dtype=dtype, device=device)
    add = torch.as_tensor(-np.asarray(mean, np.float64) / std64, dtype=dtype,
                          device=device)
    return mul, add


def resize_weights(in_size: int, out_size: int, scale: float,
                   translation: float, device=None) -> torch.Tensor:
    """(out_size, in_size) antialiased bilinear weights: output pixel o
    samples input coordinate ``(o + 0.5 - translation) / scale - 0.5``, with
    a triangle kernel widened by 1/scale when downsampling; columns are
    normalized and samples outside the input get weight 0. The f32 formula
    of ``jax.image.scale_and_translate``."""
    f32 = dict(dtype=torch.float32, device=device)
    # scale and translation: made on the host, each copied to ``device``
    count('preprocess.host_consts', 2)
    scale_t = torch.tensor(scale, **f32)
    inv_scale = 1.0 / scale_t
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, **f32) + 0.5) * inv_scale
                - torch.tensor(translation, **f32) * inv_scale - 0.5)
    x = (sample_f[:, None] - torch.arange(in_size, **f32)[None, :]).abs() \
        / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def fused_preprocess(batch_u8, settings, channels_last: bool = True,
                     dtype: torch.dtype = torch.float32, device=None,
                     preserve_aspect_ratio: bool = True):
    """uint8 (B, H, W, 3) batch (numpy or tensor) -> normalized batch on
    ``device`` (default: the tensor's own), (B, S, S, 3) or (B, 3, S, S),
    computed in ``dtype`` (bfloat16 halves the memory traffic; uint8 values
    are exact in it)."""
    x = torch.as_tensor(batch_u8, device=device)
    if x.dim() == 3:
        x = x[None]
    (input_size, input_space, input_range, mean, std, scale) = \
        _settings_tuple(settings)
    crop = max(input_size)
    b, h, w, c = x.shape
    nh, nw = _resize_target(h, w, crop, scale, preserve_aspect_ratio,
                            input_size)
    top = int(round((nh - crop) / 2.0))
    left = int(round((nw - crop) / 2.0))
    if (nh, nw) == (h, w):
        x = x[:, top:top + crop, left:left + crop].to(dtype)
    else:
        # resize + crop in one: window pixel j samples the resized grid at
        # top + j, i.e. translation -top at scale nh/h (fused.py:101-111)
        wh = resize_weights(h, crop, nh / h, -float(top), x.device).to(dtype)
        ww = resize_weights(w, crop, nw / w, -float(left), x.device).to(dtype)
        x = x.to(dtype)
        x = torch.einsum('oh,bhwc->bowc', wh, x)
        x = torch.einsum('pw,bowc->bopc', ww, x)
    return _finalize(x, input_space, input_range, mean, std, dtype,
                     channels_last)


def _finalize(x, input_space, input_range, mean, std, dtype, channels_last):
    """The tail of the eval and train chains: channel order, the normalize
    FMA and the layout."""
    if input_space == 'BGR':
        x = x.flip(-1)
    mul, add = _affine_consts(input_range, mean, std, dtype, x.device)
    x = torch.addcmul(add, x, mul)
    if not channels_last:
        x = x.permute(0, 3, 1, 2)
    return x.contiguous()


def _window(starts, crop, flip, device):
    """(B, crop) indices of each sample's window, reversed where
    ``flip``."""
    idx = starts[:, None] + torch.arange(crop)
    if flip is not None:
        idx = torch.where(flip[:, None], idx.flip(1), idx)
    return idx.to(device)


def fused_train_apply(batch_u8, settings, tops, lefts, hflip, vflip=None,
                      channels_last: bool = True,
                      dtype: torch.dtype = torch.float32, device=None,
                      preserve_aspect_ratio: bool = True):
    """The deterministic core of ``fused_train_preprocess``: each image of
    the uint8 (B, H, W, 3) batch resized to the eval chain's (nh, nw) (the
    weights of ``jax.image.resize``), its crop x crop window at row
    ``tops[i]`` and column ``lefts[i]`` taken, mirrored where ``hflip[i]``
    and turned upside down where ``vflip[i]``, then normalized.

    Only the window's pixels are computed: each sample's rows of the two
    resize matrices are gathered, so the resize and the crop are one pair
    of batched matmuls. When the resize is the identity the uint8 window
    is gathered first, as the JAX chain does (fused.py:155-175)."""
    x = torch.as_tensor(batch_u8, device=device)
    if x.dim() == 3:
        x = x[None]
    (input_size, input_space, input_range, mean, std, scale) = \
        _settings_tuple(settings)
    crop = max(input_size)
    b, h, w, c = x.shape
    nh, nw = _resize_target(h, w, crop, scale, preserve_aspect_ratio,
                            input_size)
    tops, lefts = (torch.tensor(np.asarray(t), dtype=torch.long)
                   for t in (tops, lefts))
    hflip = torch.tensor(np.asarray(hflip), dtype=torch.bool)
    if vflip is not None:
        vflip = torch.tensor(np.asarray(vflip), dtype=torch.bool)
    for name, t, hi in (('tops', tops, nh - crop), ('lefts', lefts,
                                                   nw - crop)):
        if t.shape != (b,) or int(t.min()) < 0 or int(t.max()) > hi:
            raise ValueError(f'{name} must be {b} offsets in [0, {hi}], got '
                             f'{t.tolist()}')
    rows = _window(tops, crop, vflip, x.device)
    cols = _window(lefts, crop, hflip, x.device)
    if (nh, nw) == (h, w):
        x = x[torch.arange(b, device=x.device)[:, None, None],
              rows[:, :, None], cols[:, None, :]].to(dtype)
    else:
        wh = resize_weights(h, nh, nh / h, 0.0, x.device)[rows].to(dtype)
        ww = resize_weights(w, nw, nw / w, 0.0, x.device)[cols].to(dtype)
        x = torch.einsum('boh,bhwc->bowc', wh, x.to(dtype))
        x = torch.einsum('bpw,bowc->bopc', ww, x)
    return _finalize(x, input_space, input_range, mean, std, dtype,
                     channels_last)


def fused_train_preprocess(batch_u8, settings, generator: torch.Generator,
                           channels_last: bool = True,
                           dtype: torch.dtype = torch.float32, device=None,
                           preserve_aspect_ratio: bool = True,
                           random_vflip: bool = False):
    """The training twin of ``fused_preprocess``: a uniform crop position
    per sample and a horizontal flip with p = 0.5 (a vertical one too with
    ``random_vflip``), drawn on the host from ``generator`` (a CPU
    ``torch.Generator``; the same seed gives the same batch), then
    ``fused_train_apply`` on ``device``."""
    shape = tuple(np.shape(batch_u8))
    h, w = shape[-3:-1]
    (input_size, _, _, _, _, scale) = _settings_tuple(settings)
    crop = max(input_size)
    b = shape[0] if len(shape) == 4 else 1
    nh, nw = _resize_target(h, w, crop, scale, preserve_aspect_ratio,
                            input_size)
    tops = torch.randint(0, nh - crop + 1, (b,), generator=generator)
    lefts = torch.randint(0, nw - crop + 1, (b,), generator=generator)
    hflip = torch.rand(b, generator=generator) < 0.5
    vflip = (torch.rand(b, generator=generator) < 0.5 if random_vflip
             else None)
    return fused_train_apply(batch_u8, settings, tops, lefts, hflip, vflip,
                             channels_last=channels_last, dtype=dtype,
                             device=device,
                             preserve_aspect_ratio=preserve_aspect_ratio)


def ten_crop(x: torch.Tensor, crop: int, channels_last: bool = True):
    """The 10-crop eval: the 4 corners and the center, then each of them
    mirrored. (B, H, W, C) -> (B, 10, crop, crop, C), or (B, C, H, W) ->
    (B, 10, C, crop, crop) when not ``channels_last``."""
    h, w = x.shape[1:3] if channels_last else x.shape[2:4]
    positions = [(0, 0), (0, w - crop), (h - crop, 0),
                 (h - crop, w - crop), ((h - crop) // 2, (w - crop) // 2)]
    if channels_last:
        crops = [x[:, t:t + crop, l:l + crop] for t, l in positions]
    else:
        crops = [x[:, :, t:t + crop, l:l + crop] for t, l in positions]
    crops = torch.stack(crops, dim=1)
    return torch.cat([crops, crops.flip(3 if channels_last else 4)], dim=1)


def preprocess_clip(frames_u8, settings, channels_last: bool = True,
                    dtype: torch.dtype = torch.float32, device=None):
    """Video clip: uint8 (T, H, W, 3) -> (1, T, S, S, 3) normalized, or
    (1, 3, T, S, S) (NCTHW, what the models take) when not channels_last.
    Counted in the counter ``preprocess.clips`` and timed by the span
    ``preprocess.clip``."""
    count('preprocess.clips')
    with span('preprocess.clip'):
        out = fused_preprocess(frames_u8, settings, channels_last=True,
                               dtype=dtype, device=device)[None]
        if not channels_last:
            out = out.permute(0, 4, 1, 2, 3).contiguous()
    return out
