"""VGG 11 / 13 / 16 / 19, with and without BN (torchvision-weight compatible).

Counterpart of ``pretorched_tpu/models/vgg.py`` (reference:
pretorched/models/torchvision_models.py:600-725), in NCHW. ``features``
runs the conv stack (``features.{idx}``, torchvision's indices of conv, BN,
ReLU and pool), flatten and the classifier through ``linear1``, before its
ReLU; ``logits`` is ReLU, dropout, ``last_linear``. The hosted files call
``linear0``, ``linear1`` and ``last_linear`` ``classifier.0``, ``.3`` and
``.6``.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from .layers import batch_norm, conv2d, linear, register_features

model_urls = {
    'vgg11': 'https://download.pytorch.org/models/vgg11-bbd30ac9.pth',
    'vgg13': 'https://download.pytorch.org/models/vgg13-c768596a.pth',
    'vgg16': 'https://download.pytorch.org/models/vgg16-397923af.pth',
    'vgg19': 'https://download.pytorch.org/models/vgg19-dcbb9e9d.pth',
    'vgg11_bn': 'https://download.pytorch.org/models/vgg11_bn-6002323d.pth',
    'vgg13_bn': 'https://download.pytorch.org/models/vgg13_bn-abd245e5.pth',
    'vgg16_bn': 'https://download.pytorch.org/models/vgg16_bn-6c64b313.pth',
    'vgg19_bn': 'https://download.pytorch.org/models/vgg19_bn-c79401a0.pth',
}

pretrained_settings = {
    name: {'imagenet': image_settings(url)} for name, url in model_urls.items()
}

CFGS = {
    'A': (64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'),
    'B': (64, 64, 'M', 128, 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'),
    'D': (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M', 512, 512, 512, 'M',
          512, 512, 512, 'M'),
    'E': (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M', 512, 512, 512,
          512, 'M', 512, 512, 512, 512, 'M'),
}


def make_layers(cfg, use_bn: bool) -> nn.Sequential:
    """torchvision's ``make_layers``: the indices count every conv, BN, ReLU
    and pool."""
    layers, cin = [], 3
    for v in cfg:
        if v == 'M':
            layers.append(nn.MaxPool2d(2, 2))
            continue
        layers.append(conv2d(cin, v, 3, padding=1, bias=True))
        if use_bn:
            layers.append(batch_norm(v))
        layers.append(nn.ReLU())
        cin = v
    return nn.Sequential(*layers)


class VGG(PretrainedModel):
    """Every field of the JAX ``VGG``."""

    def __init__(self, cfg: Sequence[Union[int, str]], use_bn: bool = False,
                 num_classes: int = 1000):
        super().__init__(num_classes, 4096)
        self.use_bn = use_bn
        register_features(self, make_layers(cfg, use_bn))
        self.linear0 = linear(512 * 7 * 7, 4096)
        self.dropout0 = nn.Dropout(0.5)
        self.linear1 = linear(4096, 4096)
        self.dropout1 = nn.Dropout(0.5)
        self.last_linear = linear(4096, num_classes)

    def _features(self, x):
        x = self._modules['features'](x).flatten(1)          # 512*7*7
        return self.linear1(self.dropout0(F.relu(self.linear0(x))))

    def _logits(self, features):
        return self.last_linear(self.dropout1(F.relu(features)))


TORCH_RENAMES = {
    'linear0': 'classifier.0',
    'linear1': 'classifier.3',
    'last_linear': 'classifier.6',
}

VARIANTS = {
    'vgg11': ('A', False), 'vgg11_bn': ('A', True),
    'vgg13': ('B', False), 'vgg13_bn': ('B', True),
    'vgg16': ('D', False), 'vgg16_bn': ('D', True),
    'vgg19': ('E', False), 'vgg19_bn': ('E', True),
}


def _factory(name):
    def fn(num_classes: int = 1000, pretrained: str = 'imagenet'):
        from ..core.factory import build_model
        cfg_key, use_bn = VARIANTS[name]
        model = VGG(CFGS[cfg_key], use_bn=use_bn, num_classes=num_classes)
        return build_model(name, model, pretrained_settings, num_classes,
                           pretrained, torch_renames=TORCH_RENAMES)
    fn.__name__ = name
    fn.__doc__ = f'VGG model, configuration {VARIANTS[name][0]}' + (
        ' with batch normalization' if VARIANTS[name][1] else '')
    return register_model(fn, name=name)


vgg11 = _factory('vgg11')
vgg11_bn = _factory('vgg11_bn')
vgg13 = _factory('vgg13')
vgg13_bn = _factory('vgg13_bn')
vgg16 = _factory('vgg16')
vgg16_bn = _factory('vgg16_bn')
vgg19 = _factory('vgg19')
vgg19_bn = _factory('vgg19_bn')

register_settings(pretrained_settings)
