"""ResNeXt-101 32x4d / 64x4d.

Counterpart of ``pretorched_tpu/models/resnext.py`` (reference:
pretorched/models/resnext.py and its Lambda-graph Torch7 ports), a clean
grouped-convolution ResNeXt in NCHW: a 7x7 / 2 stem, BN, ReLU and a 3x3 / 2
max pool padded 1; stages (3, 4, 23, 3) of SENet's grouped bottleneck
without its squeeze-excite (``senet.Bottleneck('se_resnext', ...,
se_identity=True)``: 1x1, grouped 3x3 of ``planes * base_width / 64 *
cardinality`` channels carrying the stride, 1x1, a strided 1x1 projection);
head: a fixed 7x7 average pool at stride 1 (so 224 px inputs) and
``last_linear``.

The hosted files' keys are the Lambda graph's auto-indices, so they load by
position: ``ordered_leaves()`` lists the port's leaf modules in the graph's
creation order and ``zoo.convert.convert_state_dict_ordered`` zips them
with the checkpoint's modules in registration order, checking each shape.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import avg_pool, max_pool
from .layers import batch_norm, conv2d, linear
from .senet import Bottleneck

pretrained_settings = {
    'resnext101_32x4d': {'imagenet': image_settings(
        'http://pretorched-x.csail.mit.edu/models/resnext101_32x4d-429f0673.pth')},
    'resnext101_64x4d': {'imagenet': image_settings(
        'http://pretorched-x.csail.mit.edu/models/resnext101_64x4d-d75443fc.pth')},
}


class ResNeXt(PretrainedModel):
    """Every field of the JAX ``ResNeXt``."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3),
                 cardinality: int = 32, base_width: int = 4,
                 num_classes: int = 1000):
        super().__init__(num_classes, 2048)
        self.layers = tuple(layers)
        self.cardinality, self.base_width = cardinality, base_width
        self.conv1 = conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = batch_norm(64)
        cin = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), self.layers, (1, 2, 2, 2)), start=1):
            mods = []
            for i in range(blocks):
                s = stride if i == 0 else 1
                mods.append(Bottleneck(
                    'se_resnext', cin, planes, cardinality, 16, s,
                    s != 1 or cin != planes * 4, 1, 0, se_identity=True,
                    base_width=base_width))
                cin = planes * 4
            setattr(self, f'layer{stage}', nn.Sequential(*mods))
        self.last_linear = linear(2048, num_classes)

    def _features(self, x):
        x = max_pool(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for stage in range(1, 5):
            x = getattr(self, f'layer{stage}')(x)
        return x

    def _logits(self, features):
        return self.last_linear(avg_pool(features, 7, 1).flatten(1))


def ordered_leaves(layers=(3, 4, 23, 3)) -> list:
    """The port's leaf-module prefixes in the Lambda graph's creation order
    (conv before its BN, the residual branch before the projection, the
    stem first, the classifier last)."""
    names = ['conv1', 'bn1']
    in_ch = 64
    for stage, blocks in enumerate(layers, start=1):
        out_ch = 64 * (2 ** (stage - 1)) * 4
        stride = 1 if stage == 1 else 2
        for i in range(blocks):
            p = f'layer{stage}.{i}'
            names += [f'{p}.conv1', f'{p}.bn1', f'{p}.conv2', f'{p}.bn2',
                      f'{p}.conv3', f'{p}.bn3']
            s = stride if i == 0 else 1
            if s != 1 or in_ch != out_ch:
                names += [f'{p}.downsample.0', f'{p}.downsample.1']
            in_ch = out_ch
    names.append('last_linear')
    return names


def _factory(name, cardinality, base_width):
    def fn(num_classes: int = 1000, pretrained: str = 'imagenet'):
        from ..core.factory import build_model
        model = ResNeXt(cardinality=cardinality, base_width=base_width,
                        num_classes=num_classes)
        return build_model(name, model, pretrained_settings, num_classes,
                           pretrained, ordered_leaves=ordered_leaves())
    fn.__name__ = name
    fn.__doc__ = f'{name} (grouped-convolution ResNeXt, Torch7-port weights).'
    return register_model(fn, name=name)


resnext101_32x4d = _factory('resnext101_32x4d', 32, 4)
resnext101_64x4d = _factory('resnext101_64x4d', 64, 4)

register_settings(pretrained_settings)
