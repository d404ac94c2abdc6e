"""SqueezeNet 1.0 / 1.1 (torchvision-weight compatible).

Counterpart of ``pretorched_tpu/models/squeezenet.py`` (reference:
pretorched/models/torchvision_models.py:535-610), in NCHW. The head is a
1x1 conv (``last_conv``, ``classifier.1`` in the hosted files), ReLU and a
global average pool, so there is **no** ``last_linear``
(torchvision_models.py:542-543): it is None, as the JAX wrapper's, and
``reset_classifier`` raises.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import adaptive_avg_pool
from .layers import conv2d, register_features

pretrained_settings = {
    'squeezenet1_0': {'imagenet': image_settings(
        'https://download.pytorch.org/models/squeezenet1_0-a815701f.pth')},
    'squeezenet1_1': {'imagenet': image_settings(
        'https://download.pytorch.org/models/squeezenet1_1-f364aa15.pth')},
}


class Fire(nn.Module):
    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = conv2d(cin, squeeze, 1, bias=True)
        self.expand1x1 = conv2d(squeeze, expand, 1, bias=True)
        self.expand3x3 = conv2d(squeeze, expand, 3, padding=1, bias=True)

    def forward(self, x):
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)),
                          F.relu(self.expand3x3(x))], dim=1)


def _pool():
    return nn.MaxPool2d(3, 2, ceil_mode=True)


class SqueezeNet(PretrainedModel):
    """Every field of the JAX ``SqueezeNet``."""

    def __init__(self, version: str = '1_0', num_classes: int = 1000):
        if version not in ('1_0', '1_1'):
            raise ValueError(f"version must be '1_0' or '1_1', got {version!r}")
        super().__init__(num_classes, 512)
        self.version = version
        if version == '1_0':
            layers = [conv2d(3, 96, 7, stride=2, bias=True), nn.ReLU(),
                      _pool(), Fire(96, 16, 64), Fire(128, 16, 64),
                      Fire(128, 32, 128), _pool(), Fire(256, 32, 128),
                      Fire(256, 48, 192), Fire(384, 48, 192),
                      Fire(384, 64, 256), _pool(), Fire(512, 64, 256)]
        else:
            layers = [conv2d(3, 64, 3, stride=2, bias=True), nn.ReLU(),
                      _pool(), Fire(64, 16, 64), Fire(128, 16, 64), _pool(),
                      Fire(128, 32, 128), Fire(256, 32, 128), _pool(),
                      Fire(256, 64, 256), Fire(512, 64, 256),
                      Fire(512, 64, 256), Fire(512, 64, 256)]
        register_features(self, nn.Sequential(*layers))
        self.dropout = nn.Dropout(0.5)
        self.last_conv = conv2d(512, num_classes, 1, bias=True)
        self.last_linear = None

    def _features(self, x):
        return self._modules['features'](x)

    def _logits(self, features):
        x = F.relu(self.last_conv(self.dropout(features)))
        return adaptive_avg_pool(x, 1).flatten(1)

    def reset_classifier(self, num_classes, generator=None):
        raise ValueError(f'{self.name} has no linear head')


TORCH_RENAMES = {'last_conv': 'classifier.1'}


def _factory(name, version):
    def fn(num_classes: int = 1000, pretrained: str = 'imagenet'):
        from ..core.factory import build_model
        return build_model(name, SqueezeNet(version, num_classes),
                           pretrained_settings, num_classes, pretrained,
                           torch_renames=TORCH_RENAMES)
    fn.__name__ = name
    fn.__doc__ = f'SqueezeNet {version.replace("_", ".")}'
    return register_model(fn, name=name)


squeezenet1_0 = _factory('squeezenet1_0', '1_0')
squeezenet1_1 = _factory('squeezenet1_1', '1_1')

register_settings(pretrained_settings)
