"""Pooling with torch semantics on channels-first layouts.

Counterpart of ``pretorched_tpu/ops/pooling.py``, which rebuilds torch's
pooling rules on channels-last XLA reductions. PyTorch has the same rules
natively, so these are thin wrappers over ``torch.nn.functional`` on
``(N, C, *spatial)`` tensors with 1 to 3 spatial dims:

* ``ceil_mode`` (the last window is dropped when it would start inside the
  right padding) and ``count_include_pad`` (explicit zero padding counts
  toward the divisor, the implicit ceil-mode overhang never does) are
  torch's own output-size and divisor rules, which the JAX module copies;
* the adaptive pools split windows at floor(i * size / out) and
  ceil((i + 1) * size / out), as torch's ``AdaptiveAvgPool`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_ADAPTIVE_AVG = {1: F.adaptive_avg_pool1d, 2: F.adaptive_avg_pool2d,
                 3: F.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: F.adaptive_max_pool1d, 2: F.adaptive_max_pool2d,
                 3: F.adaptive_max_pool3d}


def max_pool(x: torch.Tensor, kernel_size, stride=None, padding=0,
             ceil_mode: bool = False):
    """Max pool over every spatial dim of ``x`` like ``torch.nn.MaxPoolNd``
    (stride defaults to the kernel size)."""
    return _MAX_POOL[x.dim() - 2](x, kernel_size, stride, padding,
                                  ceil_mode=ceil_mode)


def avg_pool(x: torch.Tensor, kernel_size, stride=None, padding=0,
             ceil_mode: bool = False, count_include_pad: bool = True):
    """Average pool over every spatial dim of ``x`` like
    ``torch.nn.AvgPoolNd``."""
    return _AVG_POOL[x.dim() - 2](x, kernel_size, stride, padding,
                                  ceil_mode=ceil_mode,
                                  count_include_pad=count_include_pad)


def adaptive_avg_pool(x: torch.Tensor, output_size):
    return _ADAPTIVE_AVG[x.dim() - 2](x, output_size)


def adaptive_max_pool(x: torch.Tensor, output_size):
    return _ADAPTIVE_MAX[x.dim() - 2](x, output_size)


def adaptive_avgmax_pool2d(x: torch.Tensor, pool_type: str = 'avg',
                           output_size=1):
    """DPN-style combined pooling (reference: dpn.py:407-428): ``avg`` |
    ``max`` | ``avgmax`` (mean of both, in f32) | ``avgmaxc`` (the two
    concatenated along channels)."""
    if pool_type == 'avgmaxc':
        return torch.cat([adaptive_avg_pool(x, output_size),
                          adaptive_max_pool(x, output_size)], dim=1)
    if pool_type == 'avgmax':
        return (0.5 * (adaptive_avg_pool(x, output_size).float()
                       + adaptive_max_pool(x, output_size).float())
                ).to(x.dtype)
    if pool_type == 'max':
        return adaptive_max_pool(x, output_size)
    return adaptive_avg_pool(x, output_size)


def global_avg_pool(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    """Mean over every spatial dim: ``(N, C, *spatial) -> (N, C)``, or
    ``(N, C, 1, ...)`` with ``keepdims``."""
    return x.mean(dim=tuple(range(2, x.dim())), keepdim=keepdims)
