"""DenseNet 121 / 161 / 169 / 201 (torchvision-weight compatible).

Counterpart of ``pretorched_tpu/models/densenet.py`` (reference:
pretorched/models/torchvision_models.py:254-378), in NCHW with
torchvision's key names (``features.denseblock1.denselayer1.norm1``):
``features`` runs the stem, the dense blocks and transitions and ends at
``norm5`` (no ReLU); ``logits`` is ReLU, a fixed 7x7 average pool at stride
1 (the reference keeps it rather than a global pool), flatten and
``last_linear`` (``classifier`` in the hosted files). Old checkpoints' dotted
keys (``norm.1``) are rewritten on load (``zoo.convert.densenet_key_rewrite``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import avg_pool, max_pool
from .layers import batch_norm, conv2d, linear, register_features

model_urls = {
    'densenet121': 'https://download.pytorch.org/models/densenet121-241335ed.pth',
    'densenet169': 'https://download.pytorch.org/models/densenet169-6f0f7f60.pth',
    'densenet201': 'https://download.pytorch.org/models/densenet201-4c113574.pth',
    'densenet161': 'https://download.pytorch.org/models/densenet161-17b70270.pth',
}

pretrained_settings = {
    name: {'imagenet': image_settings(url)} for name, url in model_urls.items()
}
pretrained_settings['densenet161']['places365'] = image_settings(
    'http://pretorched-x.csail.mit.edu/models/densenet161_places365-62bbf0d4.pth',
    num_classes=365)

CONFIGS = {
    # (growth_rate, block_config, num_init_features)
    'densenet121': (32, (6, 12, 24, 16), 64),
    'densenet169': (32, (6, 12, 32, 32), 64),
    'densenet201': (32, (6, 12, 48, 32), 64),
    'densenet161': (48, (6, 12, 36, 24), 96),
}


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int):
        super().__init__()
        self.norm1 = batch_norm(cin)
        self.conv1 = conv2d(cin, bn_size * growth_rate, 1)
        self.norm2 = batch_norm(bn_size * growth_rate)
        self.conv2 = conv2d(bn_size * growth_rate, growth_rate, 3, padding=1)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return torch.cat([x, out], dim=1)


class Transition(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = batch_norm(cin)
        self.conv = conv2d(cin, cout, 1)

    def forward(self, x):
        return avg_pool(self.conv(F.relu(self.norm(x))), 2, 2)


class Features(nn.Module):
    def __init__(self, growth_rate, block_config, num_init_features, bn_size):
        super().__init__()
        self.conv0 = conv2d(3, num_init_features, 7, stride=2, padding=3)
        self.norm0 = batch_norm(num_init_features)
        ch = num_init_features
        self.stages = []
        for bi, layers in enumerate(block_config, start=1):
            block = nn.Sequential()
            for li in range(layers):
                block.add_module(f'denselayer{li + 1}',
                                 DenseLayer(ch, growth_rate, bn_size))
                ch += growth_rate
            setattr(self, f'denseblock{bi}', block)
            self.stages.append(f'denseblock{bi}')
            if bi != len(block_config):
                setattr(self, f'transition{bi}', Transition(ch, ch // 2))
                self.stages.append(f'transition{bi}')
                ch //= 2
        self.norm5 = batch_norm(ch)
        self.num_features = ch

    def forward(self, x):
        x = max_pool(F.relu(self.norm0(self.conv0(x))), 3, 2, 1)
        for name in self.stages:
            x = getattr(self, name)(x)
        return self.norm5(x)


class DenseNet(PretrainedModel):
    """Every field of the JAX ``DenseNet``."""

    def __init__(self, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4,
                 num_classes: int = 1000):
        features = Features(growth_rate, tuple(block_config),
                            num_init_features, bn_size)
        super().__init__(num_classes, features.num_features)
        register_features(self, features)
        self.last_linear = linear(self.num_features, num_classes)

    def _features(self, x):
        return self._modules['features'](x)

    def _logits(self, features):
        return self.last_linear(avg_pool(F.relu(features), 7, 1).flatten(1))


TORCH_RENAMES = {'last_linear': 'classifier'}


def _factory(name):
    def fn(num_classes: int = 1000, pretrained: str = 'imagenet'):
        from ..core.factory import build_model
        from ..zoo.convert import densenet_key_rewrite
        growth, blocks, init = CONFIGS[name]
        model = DenseNet(growth, blocks, init, num_classes=num_classes)
        return build_model(name, model, pretrained_settings, num_classes,
                           pretrained, torch_renames=TORCH_RENAMES,
                           key_rewrite=densenet_key_rewrite)
    fn.__name__ = name
    fn.__doc__ = f'{name} from "Densely Connected Convolutional Networks".'
    return register_model(fn, name=name)


densenet121 = _factory('densenet121')
densenet169 = _factory('densenet169')
densenet201 = _factory('densenet201')
densenet161 = _factory('densenet161')

register_settings(pretrained_settings)
