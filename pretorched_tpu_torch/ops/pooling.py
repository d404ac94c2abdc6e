"""The pooling the video slice uses, with torch semantics on NC... layouts.

Counterpart of ``pretorched_tpu/ops/pooling.py``, which rebuilds torch's
pooling rules on channels-last XLA reductions. PyTorch has them natively, so
only thin wrappers over the ops the path calls are kept here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def max_pool(x: torch.Tensor, kernel_size, stride=None, padding=0):
    """Max pool over every spatial dim of a channels-first ``x``
    (``(N, C, *spatial)``), floor mode like ``torch.nn.MaxPoolNd``."""
    return _MAX_POOL[x.dim() - 2](x, kernel_size, stride, padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over every spatial dim: ``(N, C, *spatial) -> (N, C)``."""
    return x.mean(dim=tuple(range(2, x.dim())))
