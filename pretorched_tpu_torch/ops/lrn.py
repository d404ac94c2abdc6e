"""Local response normalization across channels, channels-first.

Counterpart of ``pretorched_tpu/ops/lrn.py:15-30`` (reference:
pretorched/models/vggm.py:24-50, Caffe's ACROSS_CHANNELS LRN):
``y = x / (k + alpha * mean_window(x^2)) ** beta``. The window over the
channels is padded ``(n - 1) // 2`` in front and ``n - 1 - pad`` behind,
and its mean divides by the full window size (count_include_pad). The
squares are summed in float32. Plain tensor ops: the JAX package has no
kernel for it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def spatial_cross_map_lrn(x: torch.Tensor, local_size: int = 5,
                          alpha: float = 1e-4, beta: float = 0.75,
                          k: float = 2.0) -> torch.Tensor:
    """x: (N, C, *spatial)."""
    pad = (local_size - 1) // 2
    sq = x.float().square()
    # F.pad lists the last dim first: only the channel dim (dim 1) grows
    sq = F.pad(sq, [0, 0] * (x.dim() - 2) + [pad, local_size - 1 - pad])
    sums = sq.unfold(1, local_size, 1).sum(-1)
    div = (sums / local_size * alpha + k) ** beta
    return (x / div.to(x.dtype)).to(x.dtype)


class SpatialCrossMapLRN(nn.Module):
    """``spatial_cross_map_lrn`` as a layer (no parameters)."""

    def __init__(self, local_size=5, alpha=1e-4, beta=0.75, k=2.0):
        super().__init__()
        self.local_size, self.alpha, self.beta, self.k = (local_size, alpha,
                                                          beta, k)

    def forward(self, x):
        return spatial_cross_map_lrn(x, self.local_size, self.alpha,
                                     self.beta, self.k)
