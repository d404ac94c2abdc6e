"""MultiView ResNet: axis-aligned factored 3D convolutions.

Counterpart of ``pretorched_tpu/models/multiview.py`` (reference:
pretorched/models/multiview.py). ``MultiViewConv`` holds one 2D-shaped
weight (O, I, k, k) and reads its k * k taps as three axis-aligned 3D
kernels, (1, k, k), (k, 1, k) and (k, k, 1), by the reference's ``.view()``;
each view has its own padding and the shared stride, the bias is added to
each of the three outputs, and a ``Linear(3, 1)`` (``linear``) mixes them,
here as a weighted sum of the three cuDNN convs' outputs.

``MVResNet`` is ``VideoResNet`` with every conv a ``MultiViewConv``: the
7x7 stem, the blocks and shortcut B's 1x1x1 downsample. Groups are
ignored, as in the JAX module.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import register_model
from .layers import linear
from .resnet3d import VideoResNet


def _tup3(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


class MultiViewConv(nn.Module):
    """Shared-weight three-view conv on NCTHW tensors."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride=1, padding=0,
                 bias: bool = True):
        super().__init__()
        k = kernel_size
        self.kernel_size = k
        self.stride = _tup3(stride)
        self.padding = _tup3(padding)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.linear = linear(3, 1)
        self.jax_init = True      # init_parameters: torch_conv_init

    def extra_repr(self):
        return (f'{self.weight.shape[1]}, {self.weight.shape[0]}, '
                f'kernel_size={self.kernel_size}, stride={self.stride}, '
                f'padding={self.padding}, bias={self.bias is not None}')

    def views(self):
        """The three (O, I, kt, kh, kw) kernels and their paddings."""
        k = self.kernel_size
        o, i = self.weight.shape[:2]
        flat = self.weight.reshape(o, i, k * k)
        pt, ph, pw = self.padding
        return [(flat.reshape(o, i, 1, k, k), (0, ph, pw)),
                (flat.reshape(o, i, k, 1, k), (pt, 0, pw)),
                (flat.reshape(o, i, k, k, 1), (pt, ph, 0))]

    def forward(self, x):
        w = self.linear.weight[0]
        out = self.linear.bias[0]
        for j, (kernel, pad) in enumerate(self.views()):
            out = out + w[j] * F.conv3d(x, kernel, self.bias, self.stride,
                                        pad)
        return out


def _mv_conv(in_ch, out_ch, kernel, stride=1, padding=0, groups=1,
             plain=False):
    """A block conv of ``MVResNet``: groups ignored, as in JAX."""
    del groups, plain
    k = kernel if isinstance(kernel, int) else max(kernel)
    return MultiViewConv(in_ch, out_ch, k, stride, padding, bias=False)


class MVResNet(VideoResNet):
    """``VideoResNet`` whose convolutions are ``MultiViewConv``."""

    def __init__(self, block: str, layers, num_classes: int = 400,
                 shortcut_type: str = 'B', expansion: Optional[int] = None):
        super().__init__(block, layers, num_classes=num_classes,
                         shortcut_type=shortcut_type, expansion=expansion)

    def _conv_maker(self, factored):
        return _mv_conv

    def _stem(self, factored, s2d_stem):
        return MultiViewConv(3, 64, 7, stride=(1, 2, 2), padding=3,
                             bias=False)


_CONFIGS = {
    'mvresnet10': ('basic', (1, 1, 1, 1)),
    'mvresnet18': ('basic', (2, 2, 2, 2)),
    'mvresnet34': ('basic', (3, 4, 6, 3)),
    'mvresnet50': ('bottleneck', (3, 4, 6, 3)),
}


def _factory(name):
    def fn(num_classes: int = 400, pretrained=None,
           shortcut_type: str = 'B'):
        from ..core.factory import build_model
        block, layers = _CONFIGS[name]
        model = MVResNet(block, layers, num_classes=num_classes,
                         shortcut_type=shortcut_type)
        return build_model(name, model, {name: {}}, num_classes, pretrained,
                           video=True)
    fn.__name__ = name
    fn.__doc__ = f'{name}: multi-view factored 3D ResNet.'
    return register_model(fn, name=name)


mvresnet10 = _factory('mvresnet10')
mvresnet18 = _factory('mvresnet18')
mvresnet34 = _factory('mvresnet34')
mvresnet50 = _factory('mvresnet50')
