"""DenseNet3D (121 / 169 / 201 / 264, video).

Counterpart of ``pretorched_tpu/models/densenet3d.py`` (reference:
pretorched/models/densenet3D.py), in NCTHW:

* stem: 7x7x7 conv at stride (1, 2, 2), padding 3, BN, ReLU, then a 3/2/1
  max pool;
* dense layer: BN, ReLU, 1x1x1 conv to ``bn_size * growth``, BN, ReLU,
  3x3x3 conv to ``growth``, concatenated to its input along the channels;
  the checkpoints' keys are dotted (``denselayer1.norm.1``), and torch
  refuses a module name with a dot, so each layer nests its two BNs and
  two convs in ``norm`` / ``conv`` containers keyed ``'1'`` and ``'2'``;
* transition: BN, ReLU, a 1x1x1 conv that halves the channels, a 2/2
  average pool;
* ``norm5`` is a 3D BN (the reference's ``BatchNorm2d`` on a 5-D tensor
  is a bug; the JAX module is the spec);
* head: ReLU, an average pool over ``(ceil(T / 16), floor(S / 32),
  floor(S / 32))``, flatten and ``last_linear`` (``classifier`` in the
  hosted torch files).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import register_model
from ..core.wrapper import PretrainedModel
from ..ops.pooling import avg_pool, max_pool
from .layers import batch_norm, linear, register_features

CONFIGS = {
    # (growth_rate, block_config, num_init_features)
    'densenet3d121': (32, (6, 12, 24, 16), 64),
    'densenet3d169': (32, (6, 12, 32, 32), 64),
    'densenet3d201': (32, (6, 12, 48, 32), 64),
    'densenet3d264': (32, (6, 12, 64, 48), 64),
}


def conv3d(in_ch, out_ch, kernel_size, stride=1, padding=0):
    """Bias-free Conv3d that ``init_parameters`` fills with
    ``torch_conv_init`` (the JAX package's ``conv3d``)."""
    conv = nn.Conv3d(in_ch, out_ch, kernel_size, stride=stride,
                     padding=padding, bias=False)
    conv.jax_init = True
    return conv


class DenseLayer3D(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int,
                 drop_rate: float):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm = nn.ModuleDict({'1': batch_norm(cin), '2': batch_norm(mid)})
        self.conv = nn.ModuleDict({'1': conv3d(cin, mid, 1),
                                   '2': conv3d(mid, growth_rate, 3,
                                               padding=1)})
        self.drop_rate = drop_rate

    def forward(self, x):
        out = self.conv['1'](F.relu(self.norm['1'](x)))
        out = self.conv['2'](F.relu(self.norm['2'](out)))
        if self.drop_rate > 0:
            out = F.dropout(out, self.drop_rate, self.training)
        return torch.cat([x, out], dim=1)


class Transition3D(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = batch_norm(cin)
        self.conv = conv3d(cin, cout, 1)

    def forward(self, x):
        return avg_pool(self.conv(F.relu(self.norm(x))), 2, 2)


class Features3D(nn.Module):
    def __init__(self, growth_rate, block_config, num_init_features, bn_size,
                 drop_rate):
        super().__init__()
        self.conv0 = conv3d(3, num_init_features, 7, stride=(1, 2, 2),
                            padding=3)
        self.norm0 = batch_norm(num_init_features)
        ch = num_init_features
        self.stages = []
        for bi, layers in enumerate(block_config, start=1):
            block = nn.Sequential()
            for li in range(layers):
                block.add_module(f'denselayer{li + 1}', DenseLayer3D(
                    ch, growth_rate, bn_size, drop_rate))
                ch += growth_rate
            setattr(self, f'denseblock{bi}', block)
            self.stages.append(f'denseblock{bi}')
            if bi != len(block_config):
                setattr(self, f'transition{bi}', Transition3D(ch, ch // 2))
                self.stages.append(f'transition{bi}')
                ch //= 2
        self.norm5 = batch_norm(ch)
        self.channels = ch

    def forward(self, x):
        x = max_pool(F.relu(self.norm0(self.conv0(x))), 3, 2, 1)
        for name in self.stages:
            x = getattr(self, name)(x)
        return self.norm5(x)


def _head_cells(sample_size, sample_duration, transitions):
    """The head pool's window and the number of positions it leaves,
    from the input size through the stem, the max pool and the
    transitions' 2/2 pools."""
    t, s = sample_duration, (sample_size - 1) // 2 + 1
    t, s = (t - 1) // 2 + 1, (s - 1) // 2 + 1
    for _ in range(transitions):
        t, s = t // 2, s // 2
    window = (int(math.ceil(sample_duration / 16)),
              int(math.floor(sample_size / 32)),
              int(math.floor(sample_size / 32)))
    return window, (t // window[0]) * (s // window[1]) ** 2


class DenseNet3D(PretrainedModel):
    """Every field of the JAX ``DenseNet3D``."""

    def __init__(self, sample_size: int = 112, sample_duration: int = 16,
                 growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4,
                 drop_rate: float = 0.0, num_classes: int = 1000):
        features = Features3D(growth_rate, tuple(block_config),
                              num_init_features, bn_size, drop_rate)
        self.head_window, cells = _head_cells(
            sample_size, sample_duration, len(block_config) - 1)
        super().__init__(num_classes, features.channels * cells)
        register_features(self, features)
        self.last_linear = linear(self.num_features, num_classes)

    def _features(self, x):
        return self._modules['features'](x)

    def _logits(self, features):
        x = avg_pool(F.relu(features), self.head_window)
        # channels-last flatten, as the JAX module's; the same as torch's
        # at the published sizes, where the pool leaves one position
        return self.last_linear(x.permute(0, 2, 3, 4, 1).flatten(1))


TORCH_RENAMES = {'last_linear': 'classifier'}


def _factory(name):
    def fn(num_classes: int = 1000, pretrained=None, sample_size: int = 112,
           sample_duration: int = 16):
        from ..core.factory import build_model
        growth, blocks, init = CONFIGS[name]
        model = DenseNet3D(sample_size=sample_size,
                           sample_duration=sample_duration,
                           growth_rate=growth, block_config=blocks,
                           num_init_features=init, num_classes=num_classes)
        return build_model(name, model, {name: {}}, num_classes, pretrained,
                           torch_renames=TORCH_RENAMES, video=True)
    fn.__name__ = name
    fn.__doc__ = f'{name}: 3D DenseNet for video.'
    return register_model(fn, name=name)


densenet3d121 = _factory('densenet3d121')
densenet3d169 = _factory('densenet3d169')
densenet3d201 = _factory('densenet3d201')
densenet3d264 = _factory('densenet3d264')
