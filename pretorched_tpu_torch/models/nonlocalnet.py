"""Non-local neural networks.

Counterpart of ``pretorched_tpu/models/nonlocalnet.py`` (reference:
pretorched/models/nonlocalnet.py). The non-local block is attention over all
T*H*W positions:

* ``embedded_gaussian`` / ``gaussian``: softmax affinity, through
  ``auto_nonlocal_attention`` (the CUDA kernel for CUDA tensors, so the
  N x N matrix never exists on the card);
* ``dot_product``: affinity / N, linear, evaluated as ``q (k^T v) / N``;
* ``concatenation``: ReLU(w.[theta_i; phi_j]) / N, with the 1x1 projection
  split into its theta and phi halves, so no N x N x 2C concat exists.

The output BN (``W.1``) is zero-initialized, so a fresh block is the identity
(nonlocalnet.py:94-101). ``NonLocalBlock1D/2D/3D`` fix its dimension;
``MNISTNonLocalNet`` is the reference's 2D tutorial net.
``NonLocalResNet3D`` places blocks every ``blocks // nonlocal_blocks``
residual blocks of a stage (5 blocks -> [0, 2, 3, 0]), and loads the plain resnet3d50 Kinetics checkpoint with
strict=False (nonlocalnet.py:564): that checkpoint carries no non-local
weights and uses shortcut B, where this model defaults to A. Its stem
takes ``s2d_stem`` as ``VideoResNet`` does (the JAX class accepts the field
and runs the plain stem; the fold is exact, so the two agree).
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import register_model, register_settings
from ..ops.cuda.nonlocal_attention import (auto_nonlocal_attention,
                                           linear_nonlocal_attention)
from ..ops.pooling import max_pool
from .layers import batch_norm, conv2d, init_parameters, linear
from .resnet3d import VideoResNet, video_settings

_NL_URLS = {
    'kinetics-400': {
        'nonlocalresnet3d50': 'http://pretorched-x.csail.mit.edu/models/resnet3d50_kinetics-aad059c9.pth',
    },
    'moments': {},
}

pretrained_settings = video_settings(['nonlocalresnet3d50'], urls=_NL_URLS)

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}
_MODES = ('embedded_gaussian', 'gaussian', 'dot_product', 'concatenation')


class _Pool2(nn.Module):
    """2x max pool over every spatial dim (``sub_sample``)."""

    def forward(self, x):
        return max_pool(x, 2, 2)


class NonLocalBlock(nn.Module):
    """N-d non-local block on channels-first input ``(B, C, *spatial)``.

    State-dict keys follow the reference: ``g``/``theta``/``phi`` (``g.0``,
    ``phi.0`` under ``sub_sample``), ``W.0``/``W.1`` (conv + BN) or ``W``,
    and ``concat_project.0``."""

    def __init__(self, in_channels: int, inter_channels: Optional[int] = None,
                 dimension: int = 3, mode: str = 'embedded_gaussian',
                 sub_sample: bool = False, bn_layer: bool = True):
        super().__init__()
        if mode not in _MODES:
            raise ValueError(f'unknown non-local mode {mode!r}')
        self.in_channels = in_channels
        self.inter = inter_channels or max(in_channels // 2, 1)
        self.mode = mode
        self.sub_sample = sub_sample
        conv = _CONV[dimension]

        def branch():
            c = conv(in_channels, self.inter, 1)
            return nn.Sequential(c, _Pool2()) if sub_sample else c

        self.g = branch()
        if mode != 'gaussian':
            self.theta = conv(in_channels, self.inter, 1)
            self.phi = branch()
        if mode == 'concatenation':
            self.concat_project = nn.Sequential(
                nn.Conv2d(2 * self.inter, 1, 1, bias=False), nn.ReLU())
        if bn_layer:
            last = batch_norm(in_channels)
            self.W = nn.Sequential(conv(self.inter, in_channels, 1), last)
        else:
            last = self.W = conv(self.inter, in_channels, 1)
            nn.init.zeros_(last.bias)
        nn.init.zeros_(last.weight)
        last.zero_init = True        # kept by layers.init_parameters

    @staticmethod
    def _flat(t):
        """(B, C, *spatial) -> (B, N, C), positions in (T, H, W) order."""
        return t.flatten(2).transpose(1, 2)

    def forward(self, x):
        b, spatial = x.shape[0], x.shape[2:]
        g = self._flat(self.g(x))
        if self.mode == 'gaussian':
            theta = self._flat(x)
            phi = self._flat(max_pool(x, 2, 2) if self.sub_sample else x)
            y = auto_nonlocal_attention(theta, phi, g)
        else:
            theta = self._flat(self.theta(x))
            phi = self._flat(self.phi(x))
            if self.mode == 'embedded_gaussian':
                y = auto_nonlocal_attention(theta, phi, g)
            elif self.mode == 'dot_product':
                y = linear_nonlocal_attention(theta, phi, g)
            else:
                y = self._concatenation(theta, phi, g)
        y = y.transpose(1, 2).reshape(b, self.inter, *spatial)
        return self.W(y) + x

    def _concatenation(self, theta, phi, g):
        """f_ij = ReLU(w_t.theta_i + w_p.phi_j); y = (f @ g) / Nk
        (nonlocalnet.py:213-243)."""
        w = self.concat_project[0].weight.reshape(2 * self.inter)
        a = theta @ w[:self.inter].to(theta.dtype)          # (B, N)
        c = phi @ w[self.inter:].to(phi.dtype)              # (B, Nk)
        f = F.relu(a[:, :, None] + c[:, None, :])
        return torch.bmm(f, g) / f.shape[-1]


def NonLocalBlock1D(in_channels, **kw):
    return NonLocalBlock(in_channels, dimension=1, **kw)


def NonLocalBlock2D(in_channels, **kw):
    return NonLocalBlock(in_channels, dimension=2, **kw)


def NonLocalBlock3D(in_channels, **kw):
    return NonLocalBlock(in_channels, dimension=3, **kw)


class MNISTNonLocalNet(nn.Module):
    """The tutorial 2D non-local net (reference: nonlocalnet.py:273-305;
    ``pretorched_tpu/models/nonlocalnet.py:140-160``) on (B, 1, 28, 28)
    images: three conv -> BN -> ReLU -> 2x2 max pool stages, a non-local
    block before the second and the third (attention at N = 196, C = 16
    and N = 49, C = 32), then ``fc1`` (256) and ``fc2`` (10). The conv
    features are flattened in (H, W, C) order, as the JAX module flattens
    its channels-last map, so ``fc1`` carries across unchanged. Its
    parameters start from ``generator`` (seed 0 by default)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        in_ch = 1
        for i, ch in enumerate((32, 64, 128)):
            if i > 0:
                setattr(self, f'nonlocal{i}', NonLocalBlock2D(in_ch))
            setattr(self, f'conv{i}', conv2d(in_ch, ch, 3, padding=1,
                                             bias=True))
            setattr(self, f'bn{i}', batch_norm(ch))
            in_ch = ch
        self.fc1 = linear(128 * 3 * 3, 256)
        self.fc2 = linear(256, 10)
        init_parameters(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x):
        for i in range(3):
            if i > 0:
                x = getattr(self, f'nonlocal{i}')(x)
            x = getattr(self, f'bn{i}')(getattr(self, f'conv{i}')(x))
            x = max_pool(F.relu(x), 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)
        return self.fc2(F.relu(self.fc1(x)))


class NonLocalResNet3D(VideoResNet):
    """VideoResNet with non-local blocks after chosen residual blocks
    (reference: nonlocalnet.py:423-508). Block ``layer{s}.{i}`` carries its
    non-local block as the child ``nonlocalblock``, which gives the
    reference's key names ``layer2.0.nonlocalblock.*``."""

    def __init__(self, block, layers, nonlocal_layers=(0, 2, 3, 0), **kw):
        super().__init__(block, layers, **kw)
        self.nonlocal_layers = tuple(nonlocal_layers)
        for stage in range(1, 5):
            blocks = self.layers[stage - 1]
            nl = self.nonlocal_layers[stage - 1]
            freq = blocks // nl if nl else 0
            for i, blk in enumerate(getattr(self, f'layer{stage}')):
                if freq and i % freq == 0:
                    blk.nonlocalblock = NonLocalBlock(blk.out_ch, dimension=3)

    def _after_block(self, x, stage, i):
        blk = getattr(self, f'layer{stage}')[i]
        nl = getattr(blk, 'nonlocalblock', None)
        return x if nl is None else nl(x)


_CONFIGS = {
    'nonlocalresnet3d18': ('basic', (2, 2, 2, 2)),
    'nonlocalresnet3d34': ('basic', (3, 4, 6, 3)),
    'nonlocalresnet3d50': ('bottleneck', (3, 4, 6, 3)),
    'nonlocalresnet3d101': ('bottleneck', (3, 4, 23, 3)),
    'nonlocalresnet3d152': ('bottleneck', (3, 8, 36, 3)),
}


def _build(name, num_classes, pretrained, nonlocal_layers, shortcut_type='A'):
    from ..core.factory import build_model
    block, layers = _CONFIGS[name]
    model = NonLocalResNet3D(block, layers, num_classes=num_classes,
                             shortcut_type=shortcut_type,
                             nonlocal_layers=nonlocal_layers)
    settings_map = pretrained_settings if name in pretrained_settings else {name: {}}
    return build_model(name, model, settings_map, num_classes, pretrained,
                       torch_renames={'last_linear': 'fc'}, strict=False,
                       check_num_classes=False, video=True)


def _factory(name, nl=(0, 2, 3, 0)):
    def fn(num_classes: int = 339, pretrained=None,
           nonlocal_layers: Sequence[int] = nl, shortcut_type: str = 'A'):
        return _build(name, num_classes, pretrained, nonlocal_layers,
                      shortcut_type)
    fn.__name__ = name
    fn.__doc__ = f'Constructs a {name} model (non-local attention).'
    return register_model(fn, name=name)


nonlocalresnet3d18 = _factory('nonlocalresnet3d18')
nonlocalresnet3d34 = _factory('nonlocalresnet3d34')
nonlocalresnet3d101 = _factory('nonlocalresnet3d101')
nonlocalresnet3d152 = _factory('nonlocalresnet3d152')


@register_model
def nonlocalresnet3d50(num_classes: int = 339, num_nonlocal_blocks: int = 5,
                       pretrained='kinetics-400', shortcut_type: str = 'A'):
    """NonLocal ResNet3D-50 (nonlocalnet.py:552-568): 5 blocks -> [0,2,3,0],
    10 -> [0,4,6,0]; the backbone checkpoint loads with strict=False."""
    nonlocal_layers = (0, 2, 3, 0) if num_nonlocal_blocks == 5 else (0, 4, 6, 0)
    if pretrained is not None:
        # the hosted checkpoint is the plain Kinetics resnet3d50 (400 classes)
        settings = pretrained_settings['nonlocalresnet3d50'][pretrained]
        if num_classes != settings['num_classes']:
            warnings.warn(
                f'nonlocalresnet3d50 checkpoint has {settings["num_classes"]} '
                f'classes; head stays randomly initialized for {num_classes}.')
    return _build('nonlocalresnet3d50', num_classes, pretrained,
                  nonlocal_layers, shortcut_type)


register_settings(pretrained_settings)
