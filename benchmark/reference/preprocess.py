"""Plain eval preprocessing of a clip: resize, center crop, normalize.

The chain of the pretorched-x eval transforms with the JAX package's
resize (``jax.image.resize`` with ``antialias=True``, method 'linear'):

* the shorter side becomes floor(crop / scale), the other in proportion
  (rounded);
* each resized pixel r samples the input at (r + 0.5) / s - 0.5, s = the
  resized over the input size, with a triangle kernel whose width grows
  by 1 / s when s < 1; each pixel's weights are normalized to sum 1; a
  sample outside [-0.5, size - 0.5] gives 0;
* the center crop of crop x crop (offsets rounded half to even);
* x / 255 (for a [0, 1] input range), minus the mean, over the std.

The weights are computed in float64 and applied in float32; nothing is
taken from the program's resize matrices.
"""

from __future__ import annotations

import math

import torch


def resized(h, w, crop, scale):
    """(rows, cols) of the resized frame before the center crop."""
    short = int(math.floor(crop / scale))
    if h <= w:
        return short, int(round(short * w / h))
    return int(round(short * h / w)), short


def weights(in_size, out_size, first, count, device):
    """(count, in_size) float64 weights of resized pixels first..first +
    count - 1 of a resize from in_size to out_size."""
    s = out_size / in_size
    width = max(1.0 / s, 1.0)
    r = torch.arange(first, first + count, dtype=torch.float64, device=device)
    sample = (r + 0.5) / s - 0.5
    i = torch.arange(in_size, dtype=torch.float64, device=device)
    w = (1.0 - (sample[:, None] - i[None, :]).abs() / width).clamp(min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total > 0, w / total.clamp(min=1e-300), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None], w, 0.0)


def clip(frames_u8, settings, q=None):
    """uint8 (T, H, W, 3) -> float32 (3, T, crop, crop), normalized. ``q``
    rounds every operand and result (a control's lower precision)."""
    q = q or (lambda t: t)
    t, h, w, _ = frames_u8.shape
    crop = max(settings['input_size'])
    nh, nw = resized(h, w, crop, settings['scale'])
    top, left = round((nh - crop) / 2), round((nw - crop) / 2)
    wh = q(weights(h, nh, top, crop, frames_u8.device).float())
    ww = q(weights(w, nw, left, crop, frames_u8.device).float())
    x = q(frames_u8.float().permute(3, 0, 1, 2))          # (3, T, H, W)
    x = q(torch.matmul(q(torch.matmul(wh, x)), ww.t()))   # (3, T, crop, crop)
    if settings['input_space'] == 'BGR':
        x = x.flip(0)
    # x / range - mean, over std, as one multiply and one add per channel
    k = 1.0 if max(settings['input_range']) == 255 else 1.0 / 255.0
    std = torch.tensor(settings['std'], dtype=torch.float64)
    mul = (k / std).float().to(x.device)[:, None, None, None]
    add = (-torch.tensor(settings['mean'], dtype=torch.float64) / std).float(
        ).to(x.device)[:, None, None, None]
    return q(x * q(mul) + q(add))
